// Native terrain synthesis of humanoid_tpu_torch: a copy of the reference
// package's native/terrain.cpp, whose worlds this one reproduces in bits.
//
// The primitive generators plus the whole-world curriculum assembly,
// exported through a C ABI consumed via ctypes (native/terrain_native.py).
// Semantics mirror the NumPy implementation in env/terrain.py: the
// deterministic primitives (pyramid slope/stairs, gap, pit) are bit-exact
// against it; the random ones share parameters and bounds but use their
// own RNG.
//
// Built by native/build.py: g++ -O3 -shared -fPIC -std=c++17.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

namespace {

inline int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// distance to the nearest grid edge, min over both axes (the pyramid shape)
inline int edge_dist(int i, int j, int n) {
    return std::min(std::min(i, n - 1 - i), std::min(j, n - 1 - j));
}

}  // namespace

extern "C" {

// ---- primitives: all operate on a row-major n x n int16 raw grid ----

void ht_random_uniform(int16_t* h, int n, double hs, double vs,
                       double min_h, double max_h, double step,
                       double down_scale, uint64_t seed) {
    // choice from the arange(min,max+step,step) grid on a coarse lattice,
    // bilinearly upsampled (terrain.py random_uniform_terrain semantics)
    double width_m = n * hs;
    int n_down = std::max(2, (int)(width_m / down_scale));
    int n_lv = (int)std::floor((max_h - min_h) / step + 1.0 + 1e-9);
    std::mt19937_64 rng(seed);
    std::uniform_int_distribution<int> lv(0, n_lv - 1);
    std::vector<double> low((size_t)n_down * n_down);
    for (auto& v : low) v = (min_h + lv(rng) * step) / vs;

    std::vector<int> x0(n);
    std::vector<double> fx(n);
    for (int i = 0; i < n; ++i) {
        double xi = (double)i * (n_down - 1) / (n - 1 > 0 ? n - 1 : 1);
        // match numpy: index = clip(int(xi), 0, n_down-2)
        int b = clampi((int)xi, 0, n_down - 2);
        x0[i] = b;
        fx[i] = xi - b;
    }
    for (int i = 0; i < n; ++i) {
        const double* r0 = &low[(size_t)x0[i] * n_down];
        const double* r1 = r0 + n_down;
        double wi = fx[i];
        for (int j = 0; j < n; ++j) {
            double a = r0[x0[j]] * (1 - wi) + r1[x0[j]] * wi;
            double b = r0[x0[j] + 1] * (1 - wi) + r1[x0[j] + 1] * wi;
            h[(size_t)i * n + j] =
                (int16_t)(h[(size_t)i * n + j] +
                          (int16_t)(a * (1 - fx[j]) + b * fx[j]));
        }
    }
}

void ht_pyramid_slope(int16_t* h, int n, double hs, double vs, double slope,
                      double platform) {
    double center = (n - 1) / 2.0;
    double max_h = slope * (n / 2.0) * hs / vs;
    int plat_px = (int)(platform / hs / 2.0);
    double plat_cap = (center - plat_px) / center * max_h;
    for (int i = 0; i < n; ++i) {
        for (int j = 0; j < n; ++j) {
            double v = edge_dist(i, j, n) / center * max_h;
            v = slope >= 0 ? std::min(v, plat_cap) : std::max(v, plat_cap);
            h[(size_t)i * n + j] =
                (int16_t)(h[(size_t)i * n + j] + (int16_t)v);
        }
    }
}

void ht_pyramid_stairs(int16_t* h, int n, double hs, double vs,
                       double step_w, double step_h, double platform) {
    int step_px = std::max(1, (int)(step_w / hs));
    double h_px = step_h / vs;
    int plat_px = (int)(platform / hs / 2.0);
    int max_ring = std::max(0, (n / 2 - plat_px) / step_px);
    for (int i = 0; i < n; ++i) {
        for (int j = 0; j < n; ++j) {
            int ring = std::min(edge_dist(i, j, n) / step_px, max_ring);
            h[(size_t)i * n + j] =
                (int16_t)(h[(size_t)i * n + j] + (int16_t)(ring * h_px));
        }
    }
}

void ht_discrete_obstacles(int16_t* h, int n, double hs, double vs,
                           double max_height, double min_size,
                           double max_size, int num_rects, double platform,
                           uint64_t seed) {
    std::mt19937_64 rng(seed);
    std::uniform_real_distribution<double> usize(min_size, max_size);
    std::uniform_int_distribution<int> uh(0, 3);
    const double choices[4] = {-max_height, -max_height / 2, max_height / 2,
                               max_height};
    for (int r = 0; r < num_rects; ++r) {
        int w = (int)(usize(rng) / hs);
        int l = (int)(usize(rng) / hs);
        std::uniform_int_distribution<int> ux(0, std::max(0, n - w - 1));
        std::uniform_int_distribution<int> uy(0, std::max(0, n - l - 1));
        int x = ux(rng), y = uy(rng);
        int16_t v = (int16_t)(choices[uh(rng)] / vs);
        for (int i = x; i < std::min(n, x + w); ++i)
            for (int j = y; j < std::min(n, y + l); ++j)
                h[(size_t)i * n + j] = v;
    }
    int p = (int)(platform / hs / 2.0), c = n / 2;
    for (int i = c - p; i < c + p; ++i)
        for (int j = c - p; j < c + p; ++j)
            if (i >= 0 && i < n && j >= 0 && j < n) h[(size_t)i * n + j] = 0;
}

void ht_stepping_stones(int16_t* h, int n, double hs, double vs,
                        double stone_size, double stone_distance,
                        double max_height, double platform, double depth,
                        uint64_t seed) {
    std::mt19937_64 rng(seed);
    int stone_px = std::max(1, (int)(stone_size / hs));
    int dist_px = std::max(0, (int)(stone_distance / hs));
    int16_t floor_v = (int16_t)(depth / vs);
    for (size_t k = 0; k < (size_t)n * n; ++k) h[k] = floor_v;
    int period = stone_px + dist_px;
    int hmax = (int)(max_height / vs);
    std::uniform_int_distribution<int> uh(-hmax, hmax);
    for (int x0 = 0; x0 < n; x0 += period)
        for (int y0 = 0; y0 < n; y0 += period) {
            int16_t v = (int16_t)(hmax > 0 ? uh(rng) : 0);
            for (int i = x0; i < std::min(n, x0 + stone_px); ++i)
                for (int j = y0; j < std::min(n, y0 + stone_px); ++j)
                    h[(size_t)i * n + j] = v;
        }
    int p = (int)(platform / hs / 2.0), c = n / 2;
    for (int i = c - p; i < c + p; ++i)
        for (int j = c - p; j < c + p; ++j)
            if (i >= 0 && i < n && j >= 0 && j < n) h[(size_t)i * n + j] = 0;
}

void ht_gap(int16_t* h, int n, double hs, double gap_size, double platform) {
    int gap_px = (int)(gap_size / hs);
    int plat_px = (int)(platform / hs);
    int c = n / 2;
    int x1 = (n - plat_px) / 2;
    int x2 = x1 + gap_px;
    for (int i = std::max(0, c - x2); i < std::min(n, c + x2); ++i)
        for (int j = std::max(0, c - x2); j < std::min(n, c + x2); ++j)
            h[(size_t)i * n + j] = -1000;
    for (int i = std::max(0, c - x1); i < std::min(n, c + x1); ++i)
        for (int j = std::max(0, c - x1); j < std::min(n, c + x1); ++j)
            h[(size_t)i * n + j] = 0;
}

void ht_pit(int16_t* h, int n, double hs, double vs, double depth,
            double platform) {
    int d = (int)(depth / vs);
    int p = (int)(platform / hs / 2.0);
    int x1 = n / 2 - p, x2 = n / 2 + p;
    for (int i = std::max(0, x1); i < std::min(n, x2); ++i)
        for (int j = std::max(0, x1); j < std::min(n, x2); ++j)
            h[(size_t)i * n + j] = (int16_t)(-d);
}

// ---- whole-world curriculum assembly (terrain.py:86-169 +
// HumanoidTerrain parameter set, terrain.py:200-231) ----
//
// field: (rows*size_px + 2*border_px) x (cols*size_px + 2*border_px)
// doubles in meters, row-major. origins: rows*cols*3 doubles.
//
// generator_set: 0 = HumanoidTerrain's gentle set (terrain.py:200-231),
//                1 = generic base-Terrain set (terrain.py:110-143) —
//                    slopes/rough slope/stairs/discrete/stones/gap/pit.
// selected: -1 = curriculum/randomized; else force every cell to one
// primitive id (terrain.py:95-107): 0 flat, 1 rough, 2 slope, 3 stairs,
// 4 discrete, 5 stepping_stones, 6 gap, 7 pit, 8 uneven.

namespace {

void base_cell(int16_t* c, int size_px, double hs, double vs, double choice,
               double difficulty, const double* cum, int n_props,
               uint64_t cs) {
    double slope = difficulty * 0.4;
    double step_height = 0.05 + 0.18 * difficulty;
    double disc_h = 0.05 + difficulty * 0.2;
    double stones_size = 1.5 * (1.05 - difficulty);
    double stone_distance = difficulty == 0.0 ? 0.05 : 0.1;
    double gap_size = 1.0 * difficulty;
    double pit_depth = 1.0 * difficulty;
    if (choice < cum[0]) {
        if (choice < cum[0] / 2) slope = -slope;
        ht_pyramid_slope(c, size_px, hs, vs, slope, 3.0);
    } else if (n_props > 1 && choice < cum[1]) {
        ht_pyramid_slope(c, size_px, hs, vs, slope, 3.0);
        ht_random_uniform(c, size_px, hs, vs, -0.05, 0.05, 0.005, 0.2, cs);
    } else if (n_props > 3 && choice < cum[3]) {
        if (choice < cum[2]) step_height = -step_height;
        ht_pyramid_stairs(c, size_px, hs, vs, 0.31, step_height, 3.0);
    } else if (n_props > 4 && choice < cum[4]) {
        ht_discrete_obstacles(c, size_px, hs, vs, disc_h, 1.0, 2.0, 20, 3.0,
                              cs);
    } else if (n_props > 5 && choice < cum[5]) {
        ht_stepping_stones(c, size_px, hs, vs, stones_size, stone_distance,
                           0.0, 4.0, -10.0, cs);
    } else if (n_props > 6 && choice < cum[6]) {
        ht_gap(c, size_px, hs, gap_size, 3.0);
    } else {
        ht_pit(c, size_px, hs, vs, pit_depth, 4.0);
    }
}

void selected_cell(int16_t* c, int size_px, double hs, double vs,
                   int selected, double d, uint64_t cs,
                   double uneven_amplitude) {
    switch (selected) {
        case 0: break;  // flat
        case 1:
            ht_random_uniform(c, size_px, hs, vs, -0.05 - 0.05 * d,
                              0.05 + 0.05 * d, 0.005, 0.2, cs);
            break;
        case 2: ht_pyramid_slope(c, size_px, hs, vs, 0.4 * d, 3.0); break;
        case 3:
            ht_pyramid_stairs(c, size_px, hs, vs, 0.31, 0.05 + 0.18 * d,
                              3.0);
            break;
        case 4:
            ht_discrete_obstacles(c, size_px, hs, vs, 0.05 + 0.2 * d, 1.0,
                                  2.0, 20, 3.0, cs);
            break;
        case 5:
            ht_stepping_stones(c, size_px, hs, vs, 1.5 * (1.05 - d), 0.1,
                               0.0, 4.0, -10.0, cs);
            break;
        case 6: ht_gap(c, size_px, hs, 1.0 * d, 3.0); break;
        case 7: ht_pit(c, size_px, hs, vs, 1.0 * d, 4.0); break;
        case 8:
            // "uneven": the deployment oracle's spectrum (uneven.png —
            // ~1 m lattice, 0.35 m range at full difficulty); see the
            // NumPy humanoid_make_terrain docstring
            ht_random_uniform(c, size_px, hs, vs, -uneven_amplitude * d,
                              uneven_amplitude * d, 0.005, 1.0, cs);
            break;
        default: break;
    }
}

}  // namespace

void ht_build_world(double* field, double* origins, int num_rows,
                    int num_cols, int size_px, int border_px, double hs,
                    double vs, double terrain_length,
                    const double* proportions, int n_props, int curriculum,
                    int generator_set, int selected, uint64_t seed,
                    double uneven_amplitude) {
    int H = num_rows * size_px + 2 * border_px;
    int W = num_cols * size_px + 2 * border_px;
    std::memset(field, 0, sizeof(double) * (size_t)H * W);
    std::vector<double> cum(n_props);
    double acc = 0;
    for (int k = 0; k < n_props; ++k) cum[k] = (acc += proportions[k]);
    std::mt19937_64 world_rng(seed);
    std::uniform_real_distribution<double> u01(0.0, 1.0);
    std::vector<int16_t> cell((size_t)size_px * size_px);

    for (int j = 0; j < num_cols; ++j) {
        for (int i = 0; i < num_rows; ++i) {
            double difficulty, choice;
            if (curriculum) {
                difficulty = (double)i / num_rows;
                choice = (double)j / num_cols + 0.001;
            } else if (generator_set == 1) {
                // base randomized mode: difficulty in {0.5, 0.75, 0.9}
                // (terrain.py:79-81)
                const double lv[3] = {0.5, 0.75, 0.9};
                difficulty = lv[(int)(u01(world_rng) * 3.0) % 3];
                choice = u01(world_rng);
            } else {
                difficulty = u01(world_rng);
                choice = u01(world_rng);
            }
            std::fill(cell.begin(), cell.end(), (int16_t)0);
            uint64_t cs = world_rng();  // per-cell seed
            double obstacle_h = difficulty * 0.04;
            double r_height = difficulty * 0.07;
            double h_slope = difficulty * 0.15;
            int16_t* c = cell.data();
            if (selected >= 0) {
                selected_cell(c, size_px, hs, vs, selected, difficulty, cs,
                              uneven_amplitude);
            } else if (generator_set == 1) {
                base_cell(c, size_px, hs, vs, choice, difficulty, cum.data(),
                          n_props, cs);
            } else if (choice < cum[0]) {
                // flat
            } else if (n_props > 1 && choice < cum[1]) {
                ht_discrete_obstacles(c, size_px, hs, vs, obstacle_h, 1.0,
                                      2.0, 20, 3.0, cs);
            } else if (n_props > 2 && choice < cum[2]) {
                ht_random_uniform(c, size_px, hs, vs, -r_height, r_height,
                                  0.005, 0.2, cs);
            } else if (n_props > 3 && choice < cum[3]) {
                ht_pyramid_slope(c, size_px, hs, vs, h_slope, 0.1);
            } else if (n_props > 4 && choice < cum[4]) {
                ht_pyramid_slope(c, size_px, hs, vs, -h_slope, 0.1);
            } else if (n_props > 5 && choice < cum[5]) {
                ht_pyramid_stairs(c, size_px, hs, vs, 0.4, obstacle_h, 1.0);
            } else if (n_props > 6 && choice < cum[6]) {
                ht_pyramid_stairs(c, size_px, hs, vs, 0.4, -obstacle_h, 1.0);
            } else if (n_props > 7 && choice < cum[7]) {
                // "uneven" long-wavelength rough (oracle spectrum;
                // amplitude from TerrainCfg.uneven_amplitude)
                ht_random_uniform(c, size_px, hs, vs,
                                  -uneven_amplitude * difficulty,
                                  uneven_amplitude * difficulty, 0.005,
                                  1.0, cs);
            }
            int x0 = border_px + i * size_px;
            int y0 = border_px + j * size_px;
            for (int a = 0; a < size_px; ++a)
                for (int b = 0; b < size_px; ++b)
                    field[(size_t)(x0 + a) * W + (y0 + b)] =
                        cell[(size_t)a * size_px + b] * vs;
            // origin z = max over the central 2x2 m patch
            int r0 = (int)((terrain_length / 2 - 1) / hs);
            int r1 = (int)((terrain_length / 2 + 1) / hs);
            int16_t zmax = -32768;
            for (int a = r0; a < r1; ++a)
                for (int b = r0; b < r1; ++b)
                    zmax = std::max(zmax, cell[(size_t)a * size_px + b]);
            double* o = &origins[((size_t)i * num_cols + j) * 3];
            o[0] = (i + 0.5) * terrain_length;
            o[1] = (j + 0.5) * terrain_length;
            o[2] = zmax * vs;
        }
    }
}

}  // extern "C"

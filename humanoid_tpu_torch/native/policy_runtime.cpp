// Native deployment policy runtime of humanoid_tpu_torch (a copy of the
// reference package's native/policy_runtime.cpp): loads an exported .npz
// policy (deploy/export.py export_policy_npz) and evaluates the ELU MLP
// with no Python/numpy/torch dependency, as robot-side code would.
//
// The .npz container is a plain uncompressed ZIP (np.savez default) of
// .npy members; this file implements just enough of both formats:
// ZIP local-file headers (method 0 = stored) and .npy v1/v2 headers with
// '<f4'/'<f8' little-endian C-order payloads.
//
// C ABI (consumed by native/policy_native.py via ctypes, or directly from
// robot control code):
//   void* ht_policy_load(const char* npz_path, const char* prefix);
//   int   ht_policy_in_dim(void* h);
//   int   ht_policy_out_dim(void* h);
//   void  ht_policy_forward(void* h, const float* obs, int batch, float* out);
//   void  ht_policy_free(void* h);
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Tensor {
  std::vector<float> data;
  std::vector<int64_t> shape;
};

struct Layer {
  std::vector<float> w;  // (in, out) row-major, as exported
  std::vector<float> b;  // (out,)
  int in = 0, out = 0;
};

struct Policy {
  std::vector<Layer> layers;
};

uint32_t rd32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd16(const uint8_t* p) {
  return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

// Parse one .npy member; returns false on unsupported layout.
bool parse_npy(const uint8_t* buf, size_t n, Tensor* out) {
  if (n < 10 || memcmp(buf, "\x93NUMPY", 6) != 0) return false;
  int major = buf[6];
  size_t hlen, hoff;
  if (major == 1) {
    hlen = rd16(buf + 8);
    hoff = 10;
  } else {
    hlen = rd32(buf + 8);
    hoff = 12;
  }
  if (hoff + hlen > n) return false;
  std::string hdr((const char*)buf + hoff, hlen);
  if (hdr.find("'fortran_order': True") != std::string::npos) return false;
  bool f8 = hdr.find("'<f8'") != std::string::npos;
  if (!f8 && hdr.find("'<f4'") == std::string::npos) return false;
  size_t sp = hdr.find("'shape':");
  if (sp == std::string::npos) return false;
  size_t lp = hdr.find('(', sp), rp = hdr.find(')', sp);
  if (lp == std::string::npos || rp == std::string::npos) return false;
  std::string dims = hdr.substr(lp + 1, rp - lp - 1);
  out->shape.clear();
  int64_t count = 1;
  for (size_t i = 0; i < dims.size();) {
    while (i < dims.size() && (dims[i] == ' ' || dims[i] == ',')) i++;
    if (i >= dims.size()) break;
    int64_t d = 0;
    bool any = false;
    while (i < dims.size() && dims[i] >= '0' && dims[i] <= '9') {
      d = d * 10 + (dims[i] - '0');
      i++;
      any = true;
    }
    if (!any) return false;
    out->shape.push_back(d);
    count *= d;
  }
  if (out->shape.empty()) {  // () scalar
    out->shape.push_back(1);
  }
  const uint8_t* payload = buf + hoff + hlen;
  size_t need = (size_t)count * (f8 ? 8 : 4);
  if (hoff + hlen + need > n) return false;
  out->data.resize(count);
  if (f8) {
    for (int64_t i = 0; i < count; i++) {
      double v;
      memcpy(&v, payload + 8 * i, 8);
      out->data[i] = (float)v;
    }
  } else {
    memcpy(out->data.data(), payload, need);
  }
  return true;
}

// Walk ZIP local-file headers; call parse_npy per stored .npy member.
bool load_npz(const char* path, const std::string& prefix,
              std::vector<Tensor>* ws, std::vector<Tensor>* bs) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(sz);
  if (fread(buf.data(), 1, sz, f) != (size_t)sz) {
    fclose(f);
    return false;
  }
  fclose(f);

  // collect by layer index so member order inside the zip never matters
  auto put = [&](std::vector<Tensor>* vec, size_t idx, Tensor&& t) {
    if (vec->size() <= idx) vec->resize(idx + 1);
    (*vec)[idx] = std::move(t);
  };
  size_t pos = 0;
  while (pos + 30 <= (size_t)sz && rd32(&buf[pos]) == 0x04034b50) {
    uint16_t method = rd16(&buf[pos + 8]);
    uint64_t csize = rd32(&buf[pos + 18]);
    uint64_t usize = rd32(&buf[pos + 22]);
    uint16_t nlen = rd16(&buf[pos + 26]);
    uint16_t xlen = rd16(&buf[pos + 28]);
    // truncated/malformed archive: the filename + extra field must fit
    // inside the buffer before anything reads past the fixed header
    if (pos + 30 + (size_t)nlen + (size_t)xlen > (size_t)sz) break;
    std::string name((const char*)&buf[pos + 30], nlen);
    // numpy's zipfile writes ZIP64 placeholders (0xFFFFFFFF) with the real
    // sizes in the 0x0001 extra field: [usize(8) if u==-1][csize(8) if c==-1]
    if (csize == 0xFFFFFFFFu || usize == 0xFFFFFFFFu) {
      size_t xp = pos + 30 + nlen, xend = xp + xlen;
      while (xp + 4 <= xend) {
        uint16_t tag = rd16(&buf[xp]), tsz = rd16(&buf[xp + 2]);
        if (tag == 0x0001) {
          size_t dp = xp + 4;
          if (usize == 0xFFFFFFFFu && dp + 8 <= xend) {
            usize = (uint64_t)rd32(&buf[dp]) |
                    ((uint64_t)rd32(&buf[dp + 4]) << 32);
            dp += 8;
          }
          if (csize == 0xFFFFFFFFu && dp + 8 <= xend) {
            csize = (uint64_t)rd32(&buf[dp]) |
                    ((uint64_t)rd32(&buf[dp + 4]) << 32);
          }
          break;
        }
        xp += 4 + tsz;
      }
    }
    size_t data_off = pos + 30 + nlen + xlen;
    if (method == 0 && data_off + csize <= (size_t)sz) {
      // strip ".npy"
      std::string key = name.size() > 4 && name.compare(name.size() - 4, 4,
                                                        ".npy") == 0
                            ? name.substr(0, name.size() - 4)
                            : name;
      char kind = 0;
      size_t idx = 0;
      if (key.size() > prefix.size() + 2 &&
          key.compare(0, prefix.size(), prefix) == 0 &&
          key[prefix.size()] == '_') {
        kind = key[prefix.size() + 1];  // 'w' or 'b'
        idx = strtoul(key.c_str() + prefix.size() + 2, nullptr, 10);
      }
      if (kind == 'w' || kind == 'b') {
        Tensor t;
        if (!parse_npy(&buf[data_off], csize, &t)) return false;
        put(kind == 'w' ? ws : bs, idx, std::move(t));
      }
    }
    pos = data_off + csize;
  }
  return !ws->empty() && ws->size() == bs->size();
}

inline float elu(float x) { return x > 0.f ? x : expm1f(x); }

}  // namespace

extern "C" {

void* ht_policy_load(const char* npz_path, const char* prefix) {
  std::vector<Tensor> ws, bs;
  if (!load_npz(npz_path, prefix ? prefix : "actor", &ws, &bs)) return nullptr;
  Policy* p = new Policy();
  for (size_t i = 0; i < ws.size(); i++) {
    if (ws[i].shape.size() != 2 || bs[i].shape.size() != 1 ||
        bs[i].shape[0] != ws[i].shape[1]) {
      delete p;
      return nullptr;
    }
    Layer L;
    L.in = (int)ws[i].shape[0];
    L.out = (int)ws[i].shape[1];
    L.w = std::move(ws[i].data);
    L.b = std::move(bs[i].data);
    p->layers.push_back(std::move(L));
  }
  return p;
}

int ht_policy_in_dim(void* h) {
  return h ? ((Policy*)h)->layers.front().in : -1;
}

int ht_policy_out_dim(void* h) {
  return h ? ((Policy*)h)->layers.back().out : -1;
}

void ht_policy_forward(void* h, const float* obs, int batch, float* out) {
  Policy* p = (Policy*)h;
  std::vector<float> x, y;
  for (int n = 0; n < batch; n++) {
    x.assign(obs + (size_t)n * p->layers.front().in,
             obs + (size_t)(n + 1) * p->layers.front().in);
    for (size_t li = 0; li < p->layers.size(); li++) {
      const Layer& L = p->layers[li];
      y.assign(L.b.begin(), L.b.end());
      // w is (in, out) row-major: accumulate rank-1 updates row by row —
      // sequential reads of w, no transpose needed
      for (int i = 0; i < L.in; i++) {
        float xi = x[i];
        if (xi == 0.f) continue;
        const float* wrow = &L.w[(size_t)i * L.out];
        for (int j = 0; j < L.out; j++) y[j] += xi * wrow[j];
      }
      if (li + 1 < p->layers.size())
        for (float& v : y) v = elu(v);
      x.swap(y);
    }
    memcpy(out + (size_t)n * p->layers.back().out, x.data(),
           sizeof(float) * p->layers.back().out);
  }
}

void ht_policy_free(void* h) { delete (Policy*)h; }

}  // extern "C"

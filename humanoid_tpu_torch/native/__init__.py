"""Native (C++) components of the port, built with g++ and loaded through
ctypes: the terrain synthesizer (terrain.cpp) and the deployment policy
runtime (policy_runtime.cpp). Each library is built at its first use
(build.py); a failed build raises."""

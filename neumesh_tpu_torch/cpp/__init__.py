"""The host-geometry library (own copy of neumesh_tpu/cpp): C++ built by
g++ at first use, bound with ctypes in native.py."""

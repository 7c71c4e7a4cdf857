"""KektorDB on PyTorch and CUDA: the port of `kektordb_tpu` to one NVIDIA
H100 (sm_90a).

  ops/      distances, the int8 quantizer, the fused scan (pass A is the
            CUDA kernel csrc/scan_pass_a.cu, pass B a torch top-k)
  index/    the index state as tensors; the scan-serving HNSW index and
            the brute-force oracle
  engine/   the in-memory Engine: indexes, metadata filters, knowledge
            graph, KV
  device.py device selection and float32 precision (TF32 off)
  native.py builds csrc/ with nvcc at first use and loads it with ctypes

The package imports torch and never jax. From the JAX package it uses only
the JAX-free text analysis (`kektordb_tpu.text`).
"""

__version__ = "0.1.0"

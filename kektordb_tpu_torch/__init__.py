"""KektorDB on PyTorch and CUDA: the port of `kektordb_tpu` to one NVIDIA
H100 (sm_90a).

  ops/      distances, the int8 quantizer, the fused scan (pass A is the
            CUDA kernel csrc/scan_pass_a_wgmma.cu, pass B a torch top-k), the
            hybrid text + decay epilogue (fuse.py), and the scan probes'
            kernels (scan_probe.py)
  index/    the index state as tensors; the HNSW index (graph build, scan
            and beam serving) and the brute-force oracle
  engine/   the in-memory Engine: indexes, metadata filters, hybrid and
            decayed search, knowledge graph, belief states, KV
  text/     BM25 and the English / Italian analyzers (a copy of the JAX
            package's JAX-free text modules)
  parallel/ sharded indexes over several devices (sharded.py) and
            replicated serving over a torch.distributed group
            (distributed.py); distboot.py forms the group
  services/ the server's services, the MiniLM encoder (minilm.py)
  client/   the Python SDK and the `tui` dashboard (copies)
  probes/   the product-ceiling and scan-prototype probes, run on the card
  device.py device selection, float32 precision (TF32 off), and the
            device-repeat setting (KEKTOR_TORCH_DEVICE_REPEAT)
  native.py builds csrc/ with nvcc at first use and loads it with ctypes

The package imports torch and never jax, and nothing of the JAX package.
"""

__version__ = "0.1.0"

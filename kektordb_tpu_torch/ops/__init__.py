"""Distance, quantization and fused-scan ops (torch)."""

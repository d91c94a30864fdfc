"""Batched decode path in PyTorch: walk (element kernel) -> lpc (LPC kernel)
-> epilogue (raw reader kernel for the shift region) -> batch, mirroring
saprobe_alac_tpu/ops."""

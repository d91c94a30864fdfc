"""Batched decode path in PyTorch: walk (element kernel) -> lpc (LPC kernel)
-> epilogue -> batch, mirroring saprobe_alac_tpu/ops."""

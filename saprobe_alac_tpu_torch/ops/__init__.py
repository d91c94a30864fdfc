"""Batched decode path in PyTorch: walk (packet kernel) -> lpc (LPC kernel)
-> epilogue (raw reader kernel for the shift region, epilogue kernel) ->
batch, mirroring saprobe_alac_tpu/ops."""

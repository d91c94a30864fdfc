"""Published peaks of the cards the benchmark runs on, by the name
`torch.cuda.get_device_name()` gives.

Memory bandwidth only: the decoder's kernels do integer work, and a card's
data sheet gives no integer rate outside the tensor cores, so no kernel's
share of an operations peak is reported.  NVIDIA H100 SXM data sheet, at
its 700 W power limit.
"""

#: Bytes per second of device memory.
MEMORY_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}

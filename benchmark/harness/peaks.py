"""Published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at
the full 700 W power limit): the yardstick of every roofline share and of
`mfu`."""
BF16_FLOPS = 989e12          # FLOP/s, bf16 / fp16 tensor cores, dense
HBM_BYTES = 3.35e12          # bytes/s, HBM3

"""K1's share of its roofline in the encoder: bound per launch at
(rows x heads, 1500, 1500, 64) times the launches counted
(ops.kernels.launch_counts), over K1's device time by name."""

from bench_h100.metrics._shared import roofline_share


def read(record):
    return roofline_share(record, "flash_forward_kernel", "k1_cases")

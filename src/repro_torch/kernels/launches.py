"""Launch counts of the port's CUDA kernels.

Each kernel wrapper adds one to its entry where it launches its kernel
and nowhere else, so a run can show that its main path went through the
kernels: zero the counts, drive the path, read them.
"""
from typing import Dict

LAUNCHES: Dict[str, int] = {"bucket_apply": 0, "tick_deliver": 0,
                            "tick_scatter": 0, "tick_scatter_rows": 0,
                            "tick_scatter_finish": 0, "cohort_clip_noise": 0,
                            "cohort_clip_noise_prng": 0,
                            "clip_accumulate": 0, "flash_attention": 0,
                            "ssd_scan": 0, "cohort_logreg_block": 0}


def reset() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0

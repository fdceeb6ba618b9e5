"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), one per TPU kernel
of the JAX package, each beside its plain PyTorch version.

Each wrapper adds one to its entry of :data:`LAUNCHES` where it launches its
kernel, and nowhere else, so a run can show that its main path went through
the kernels: reset the counts, drive the path, read them.
"""

LAUNCHES: dict[str, int] = {"skip_concat_matmul": 0, "flash_attention": 0,
                             "gated_linear_scan": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def tma_aligned(t):
    """``t`` contiguous at a 16-byte-aligned base, as TMA loads need: a
    view that starts elsewhere is copied to a fresh tensor."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``: the names
    ``repro_torch.analysis.kernel_check`` takes dtypes by."""
    return str(dtype).removeprefix("torch.")

"""Static launch checks for the port's hand-written Hopper kernels (the
port of ``repro.analysis.kernel_check``).

Each CUDA kernel under ``repro_torch/kernels/csrc`` refuses at launch what
it cannot run (``cudaErrorInvalidValue``), and its wrapper refuses it
before the launch.  This module states those constraints once, in plain
arithmetic with **neither torch nor jax imported** (dtypes by name), and
the three wrappers' ``_check_cuda_args`` take their shape, dtype and
stride verdicts from it, so the two cannot drift.  A shape the predicates
refuse raises ``ValueError`` (``TypeError`` for a dtype) with the
findings: the port's ops have no reference fallback on the card.

The constraints are the kernels' own, read from their ``.cu`` files and
wrappers:

- ``flash_attention_fwd_launch`` (``csrc/flash_attention.cu``): fp32 or
  bf16; a head dim it is built for (:data:`HEAD_DIMS`), ``Hq % Hkv == 0``;
  bf16 at :data:`WGMMA_HEAD_DIMS` takes the tensor-core route (TMA loads,
  so a row stride of ``D * 2`` bytes that is a multiple of 16 and
  16-byte-aligned bases; a 64 x 64 tile ring in
  :func:`flash_tiling`'s shared memory), everything else the SIMT route
  (16 query rows, 32-key tiles kept in fp32); a KV cache's
  ``0 < kv_valid_len <= T``, ``q_offset >= 0``.
- ``skip_concat_matmul_launch`` (``csrc/skip_matmul.cu``): fp32 or bf16;
  ``h, s (M, D)`` and ``w (2D, N)``; bf16 loads through TMA, so
  ``D % 8 == N % 8 == 0`` and aligned bases, into a ring of four
  128 x 64 / 64 x 64 tile pairs (:func:`skip_tiling`).  A last row of
  tiles under a quarter full is a ``warn``: it runs, mostly idle
  (UViT-H's M = 516 = 4 x 128 + 4).
- ``gated_linear_scan_launch`` (``csrc/linear_scan.cu``): ``a`` and ``x``
  each fp32 or bf16 (four instantiations a direction), chunks of
  :func:`scan_tiling`'s L steps over 256-channel tiles, at most
  ``INT_MAX`` blocks; rows of a byte length that is not a multiple of 16
  take the kernel's loads without TMA (a ``warn``).

Every block's dynamic shared memory must fit :data:`SMEM_OPTIN`, the
H100's opt-in limit a block (``cudaDevAttrMaxSharedMemoryPerBlockOptin``),
and the second grid dimension 65,535 blocks.

Findings come at two levels: ``error`` -- the launch is refused -- and
``warn`` -- it runs, off the kernel's fast path.  ``*_supported`` are the
errors-only booleans.
"""
from __future__ import annotations

import dataclasses

DTYPES = ("float32", "bfloat16")
ITEMSIZE = {"float32": 4, "bfloat16": 2}
SMEM_OPTIN = 232_448          # bytes of shared memory a block, H100 opt-in
GRID_Y_MAX = 65_535
INT_MAX = 2 ** 31 - 1

# flash attention: the head dims each route is built for
HEAD_DIMS = (8, 16, 32, 64, 80, 112, 128, 224)
WGMMA_HEAD_DIMS = (64, 80, 112, 128, 224)
_SIMT_ROWS, _SIMT_KEYS, _SIMT_THREADS = 16, 32, 128
_WG_ROWS, _WG_KEYS, _WG_STAGES, _WG_THREADS = 64, 64, 2, 160

# skip matmul: the bf16 wgmma tile ring and the fp32 register-tiled GEMM
_SK_M, _SK_N, _SK_K, _SK_STAGES, _SK_THREADS = 128, 64, 64, 4, 288
_SK32_M, _SK32_N, _SK32_K = 64, 64, 16

# linear scan: 256-channel tiles, chunks of at most 64 steps whose input
# tiles fit 96 KB, four compute warps and one looking back
_SC_CHANNELS, _SC_WARPS, _SC_BUDGET, _SC_MAX_L = 256, 4, 96 * 1024, 64


@dataclasses.dataclass(frozen=True)
class KernelFinding:
    level: str                   # "error" | "warn"
    detail: str
    rule: str = "shape"          # "dtype", "shape", "tma", "smem", "grid"

    def __str__(self) -> str:
        return f"{self.level}: {self.detail}"


@dataclasses.dataclass(frozen=True)
class KernelCheckReport:
    kernel: str
    params: dict
    findings: tuple[KernelFinding, ...]
    tiling: dict | None = None   # the route's tiles and shared memory

    @property
    def ok(self) -> bool:
        """No errors: the launch is taken (warnings allowed)."""
        return all(f.level != "error" for f in self.findings)

    def errors(self) -> tuple[KernelFinding, ...]:
        return tuple(f for f in self.findings if f.level == "error")

    def raise_if_refused(self) -> None:
        """Raise what a wrapper raises for a refused launch: ``TypeError``
        when a dtype is refused, else ``ValueError``, naming every
        error."""
        errs = self.errors()
        if not errs:
            return
        msg = f"{self.kernel}: " + "; ".join(f.detail for f in errs)
        raise (TypeError if any(f.rule == "dtype" for f in errs)
               else ValueError)(msg)

    def __str__(self) -> str:
        head = (f"{self.kernel}(" + ", ".join(
            f"{k}={v}" for k, v in self.params.items()) + "): "
            + ("OK" if self.ok else "UNSUPPORTED"))
        return "\n".join([head] + [f"  {f}" for f in self.findings])


class _Checker:
    def __init__(self, kernel: str, params: dict):
        self.kernel, self.params = kernel, params
        self.findings: list[KernelFinding] = []
        self.tiling: dict | None = None

    def error(self, detail: str, rule: str = "shape"):
        self.findings.append(KernelFinding("error", detail, rule))

    def warn(self, detail: str, rule: str = "shape"):
        self.findings.append(KernelFinding("warn", detail, rule))

    def dtype(self, name: str, dtype: str) -> bool:
        if dtype not in DTYPES:
            self.error(f"{name} has dtype {dtype}; the kernel takes float32 "
                       "or bfloat16", "dtype")
            return False
        return True

    def positive(self, **dims: int) -> bool:
        bad = [k for k, v in dims.items() if v <= 0]
        for k in bad:
            self.error(f"{k}={dims[k]} is degenerate (the kernel refuses an "
                       "empty launch)")
        return not bad

    def smem(self, nbytes: int, what: str):
        if nbytes > SMEM_OPTIN:
            self.error(f"{what} takes {nbytes} bytes of shared memory a "
                       f"block, over the {SMEM_OPTIN} an H100 block may opt "
                       "in to", "smem")

    def grid_y(self, n: int, what: str):
        if n > GRID_Y_MAX:
            self.error(f"{what}: {n} blocks in the grid's y dimension, over "
                       f"its {GRID_Y_MAX}", "grid")

    def report(self) -> KernelCheckReport:
        return KernelCheckReport(self.kernel, self.params,
                                 tuple(self.findings), self.tiling)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def flash_route(dtype: str, D: int) -> str:
    """``"wgmma"`` (the tensor-core route) for bf16 at
    :data:`WGMMA_HEAD_DIMS`, else ``"simt"`` -- a pure function of the
    dtype and head dim, as ``flash_attention_fwd_launch`` dispatches."""
    return "wgmma" if dtype == "bfloat16" and D in WGMMA_HEAD_DIMS \
        else "simt"


def flash_tiling(dtype: str, D: int) -> dict:
    """The route's tiles and dynamic shared memory at head dim ``D``
    (``FlashSmem<D>::TOTAL`` on the tensor-core route: a query tile and
    two K/V stages of whole 64-column boxes, the mbarriers and 1 KB of
    alignment; ``SimtSmem<D>::BYTES`` on the SIMT route: fp32 query rows
    and a padded K and V tile)."""
    if flash_route(dtype, D) == "wgmma":
        dp = 64 * _cdiv(D, 64)
        q, kv = _WG_ROWS * dp * 2, _WG_KEYS * dp * 2
        smem = q + _WG_STAGES * 2 * kv + (1 + 2 * _WG_STAGES) * 8 + 1024
        return dict(route="wgmma", query_rows=_WG_ROWS,
                    keys_per_tile=_WG_KEYS, stages=_WG_STAGES,
                    threads=_WG_THREADS, smem_bytes=smem)
    smem = (_SIMT_ROWS * D + 2 * _SIMT_KEYS * (D + 1)) * 4
    return dict(route="simt", query_rows=_SIMT_ROWS,
                keys_per_tile=_SIMT_KEYS, stages=1, threads=_SIMT_THREADS,
                smem_bytes=smem)


def check_flash_attention(B: int, S: int, T: int, Hq: int, Hkv: int,
                          D: int, *, dtype: str = "float32",
                          q_offset: int = 0, kv_valid_len: int | None = None,
                          window: int | None = None,
                          bases_aligned: bool = True) -> KernelCheckReport:
    """Static launch check for ``flash_attention_fwd_launch``: q
    ``(B, S, Hq, D)``, k and v ``(B, T, Hkv, D)`` of one dtype;
    ``bases_aligned``: every base 16-byte aligned."""
    c = _Checker("flash_attention", dict(B=B, S=S, T=T, Hq=Hq, Hkv=Hkv, D=D,
                                         dtype=dtype))
    if not c.dtype("q, k and v", dtype) or not c.positive(
            B=B, S=S, T=T, Hq=Hq, Hkv=Hkv, D=D):
        return c.report()
    if D not in HEAD_DIMS:
        c.error(f"head dim {D} not built; the kernel takes {HEAD_DIMS}")
        return c.report()
    if Hq % Hkv:
        c.error(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    valid = T if kv_valid_len is None else kv_valid_len
    if not (0 < valid <= T and q_offset >= 0):
        c.error(f"kv_valid_len {kv_valid_len} and q_offset {q_offset} for "
                f"{T} cache rows; want 0 < kv_valid_len <= T and "
                "q_offset >= 0")
    if window is not None and window <= 0:
        c.warn(f"window={window} masks every key: the output is zeros")
    tiles = flash_tiling(dtype, D)
    c.tiling = tiles
    if tiles["route"] == "wgmma":
        if (D * ITEMSIZE[dtype]) % 16:
            c.error(f"the bf16 route at head dim {D} loads through TMA, "
                    f"whose row stride of {D * 2} bytes must be a multiple "
                    "of 16", "tma")
        if not bases_aligned:
            c.error(f"the bf16 route at head dim {D} loads through TMA, "
                    "which needs 16-byte-aligned bases", "tma")
        if S < tiles["query_rows"]:
            c.warn(f"S={S} fills {S} of a tile's {tiles['query_rows']} "
                   "query rows")
    c.smem(tiles["smem_bytes"], f"the {tiles['route']} route at D={D}")
    if B * Hq > INT_MAX:
        c.error(f"B*Hq={B * Hq} blocks in the grid's x dimension", "grid")
    c.grid_y(_cdiv(S, tiles["query_rows"]), f"S={S}")
    return c.report()


def flash_attention_supported(B: int, S: int, T: int, Hq: int, Hkv: int,
                              D: int, *, dtype: str = "float32",
                              **kw) -> bool:
    return check_flash_attention(B, S, T, Hq, Hkv, D, dtype=dtype, **kw).ok


# ---------------------------------------------------------------------------
# skip-concat matmul
# ---------------------------------------------------------------------------

def skip_tiling(dtype: str) -> dict:
    """The kernel's tiles and shared memory for ``dtype``: the bf16 route's
    ring of four (128 x 64 A, 64 x 64 B) tile pairs with its mbarriers and
    1 KB of alignment (``SKIP_SMEM``), the fp32 route's two static 16 x 68
    fp32 tiles."""
    if dtype == "bfloat16":
        stage = (_SK_M * _SK_K + _SK_K * _SK_N) * 2
        return dict(route="wgmma", tile_m=_SK_M, tile_n=_SK_N,
                    k_step=_SK_K, stages=_SK_STAGES, threads=_SK_THREADS,
                    smem_bytes=_SK_STAGES * stage + 2 * _SK_STAGES * 8
                    + 1024)
    return dict(route="simt", tile_m=_SK32_M, tile_n=_SK32_N,
                k_step=_SK32_K, stages=1, threads=256,
                smem_bytes=2 * _SK32_K * (_SK32_M + 4) * 4)


def check_skip_concat_matmul(rows: int, d: int, n: int, *,
                             dtype: str = "float32",
                             bases_aligned: bool = True
                             ) -> KernelCheckReport:
    """Static launch check for ``skip_concat_matmul_launch``: h, s
    ``(rows, d)``, w ``(2d, n)`` of one dtype."""
    c = _Checker("skip_concat_matmul", dict(M=rows, D=d, N=n, dtype=dtype))
    if not c.dtype("h, s and w", dtype) or not c.positive(M=rows, D=d, N=n):
        return c.report()
    tiles = skip_tiling(dtype)
    c.tiling = tiles
    if dtype == "bfloat16":
        if d % 8 or n % 8:
            c.error("the bf16 kernel loads through TMA, which needs "
                    f"D % 8 == N % 8 == 0 (D={d}, N={n})", "tma")
        if not bases_aligned:
            c.error("the bf16 kernel loads through TMA, which needs "
                    "16-byte-aligned bases", "tma")
    c.smem(tiles["smem_bytes"], f"the {dtype} route")
    c.grid_y(_cdiv(rows, tiles["tile_m"]), f"M={rows}")
    last = rows % tiles["tile_m"]
    if 0 < last < tiles["tile_m"] // 4:
        c.warn(f"M={rows} leaves a last row of tiles {last} of "
               f"{tiles['tile_m']} rows full")
    return c.report()


def skip_concat_matmul_supported(rows: int, d: int, n: int, *,
                                 dtype: str = "float32",
                                 bases_aligned: bool = True) -> bool:
    return check_skip_concat_matmul(rows, d, n, dtype=dtype,
                                    bases_aligned=bases_aligned).ok


# ---------------------------------------------------------------------------
# gated linear scan
# ---------------------------------------------------------------------------

def scan_tiling(dtype_a: str, dtype_x: str, backward: bool = False) -> dict:
    """``Cfg<TA, TX, BWD>``: a chunk of L steps (the most, a multiple of 16
    and at most 64, whose a and x tiles -- backward: a, g and h -- fit
    96 KB), 256 channels and 160 threads a block, and its shared memory
    (the tiles, the warps' pairs, the carry-in, the mbarriers and ticket,
    128 bytes of alignment)."""
    step = _SC_CHANNELS * (ITEMSIZE[dtype_a]
                           + ITEMSIZE[dtype_x] * (2 if backward else 1))
    L = min(_SC_BUDGET // step // 16 * 16, _SC_MAX_L)
    smem = (L * step + _SC_WARPS * _SC_CHANNELS * 8 + _SC_CHANNELS * 4
            + 32 + 128)
    return dict(chunk=L, channels=_SC_CHANNELS,
                threads=_SC_WARPS * 32 + 32, smem_bytes=smem)


def check_gated_linear_scan(R: int, T: int, C: int, *,
                            dtype_a: str = "float32",
                            dtype_x: str = "float32",
                            backward: bool = False) -> KernelCheckReport:
    """Static launch check for ``gated_linear_scan_launch`` (``backward``:
    ``gated_linear_scan_bwd_launch``): a and x ``(R, T, C)``."""
    c = _Checker("gated_linear_scan", dict(R=R, T=T, C=C, dtype_a=dtype_a,
                                           dtype_x=dtype_x,
                                           backward=backward))
    ok = c.dtype("a", dtype_a) & c.dtype("x", dtype_x)
    if not ok or not c.positive(R=R, T=T, C=C):
        return c.report()
    tiles = scan_tiling(dtype_a, dtype_x, backward)
    c.tiling = tiles
    c.smem(tiles["smem_bytes"], f"the ({dtype_a}, {dtype_x}) instantiation")
    blocks = R * _cdiv(C, tiles["channels"]) * _cdiv(T, tiles["chunk"])
    if blocks > INT_MAX:
        c.error(f"{blocks} blocks (R x channel tiles x chunks), over the "
                f"kernel's {INT_MAX}", "grid")
    if any(C * ITEMSIZE[t] % 16 for t in (dtype_a, dtype_x)):
        c.warn(f"rows of C={C} are not a multiple of 16 bytes: the kernel "
               "loads them without TMA", "tma")
    return c.report()


def gated_linear_scan_supported(R: int, T: int, C: int, *,
                                dtype_a: str = "float32",
                                dtype_x: str = "float32",
                                backward: bool = False) -> bool:
    return check_gated_linear_scan(R, T, C, dtype_a=dtype_a,
                                   dtype_x=dtype_x, backward=backward).ok

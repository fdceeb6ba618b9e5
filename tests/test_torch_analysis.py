"""The port's analysis tools: the ``verify`` CLI held to the JAX package's
certificate for certificate, ``kernel_check``'s launch rules on both sides
of each (and the wrappers taking their verdicts from it), and the policy
linter's three rules on planted files and on the tree.

JAX is imported only inside the tests that compare with it.
"""
import json
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.analysis import kernel_check as kc
from repro_torch.analysis import lint, verify
from repro_torch.analysis.certificate import export_plan
from repro_torch.core.schedule import template_wave
from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.linear_scan import ops as scan_ops
from repro_torch.kernels.skip_matmul import ops as skip_ops
from repro_torch.runtime.schedule_exec import StepTables

REPO = pathlib.Path(__file__).resolve().parents[1]
CSRC = REPO / "src" / "repro_torch" / "kernels" / "csrc"


def _env(**over):
    import os
    return dict(os.environ, PYTHONPATH=str(REPO / "src"), **over)


# ---------------------------------------------------------------------------
# verify
# ---------------------------------------------------------------------------

def test_verify_certificates_equal_jax_on_skipvit26():
    """The cheapest tier-1 config (its block times are seeded, so no
    hardware preset enters the plans): every certificate, as JSON, equals
    the JAX CLI's, in the same order."""
    from repro.analysis import verify as jax_verify
    got = [c.to_dict() for c in verify.certify_config("skipvit26")]
    want = [c.to_dict() for c in jax_verify.certify_config("skipvit26")]
    assert len(got) == 25
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


def test_verify_cli_certifies_every_tier1_config(capsys):
    assert verify.main([]) == 0
    out = capsys.readouterr().out
    for name in verify.TIER1_CONFIGS:
        assert f"{name}/v1/portfolio/dp2-zero1" in out
    assert re.search(r"^(\d+)/\1 plans certified clean$", out, re.M)
    with pytest.raises(ValueError, match="unknown config"):
        verify.tier1_graph("nope")


def _jax_snapshot(path):
    """A wave plan lowered and exported by the JAX package."""
    from repro.analysis.certificate import export_plan as jax_export
    from repro.analysis.certificate import load_plan as jax_load
    from repro.core.schedule import template_wave as jax_template
    from repro.runtime.schedule_exec import StepTables as JaxTables
    tabs = JaxTables.from_schedule(
        jax_template(3, 6), folded=True,
        device_of_stage=lambda s, S=6: min(s, S - 1 - s))
    jax_export(tabs, path, name="jax-wave-d3")
    return jax_load(path).certify().summary()


def test_a_jax_snapshot_certifies_under_the_port_cli(tmp_path):
    """The snapshot format is shared: the port's CLI certifies a plan the
    JAX package exported, with JAX's summary, and stays numpy-only."""
    path = tmp_path / "jax_plan.json"
    want = _jax_snapshot(path)
    code = ("import sys\n"
            "from repro_torch.analysis.verify import main\n"
            f"rc = main(['--plan', {str(path)!r}])\n"
            "assert not [m for m in sys.modules\n"
            "            if m.split('.')[0] in ('torch', 'jax')], 'heavy'\n"
            "sys.exit(rc)\n")
    proc = subprocess.run([sys.executable, "-c", code], env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == want
    assert lines[-1] == "1/1 plans certified clean"


def test_a_mutated_plan_fails_the_cli(tmp_path):
    """Two steps of one device swapped in every table (the JAX suite's
    ``test_mutation_swap_two_steps``): the snapshot no longer certifies
    and the CLI exits 1."""
    tabs = StepTables.from_schedule(
        template_wave(3, 6), folded=True,
        device_of_stage=lambda s, S=6: min(s, S - 1 - s))
    good, bad = tmp_path / "good.json", tmp_path / "bad.json"
    export_plan(tabs, good, name="wave-d3")
    doc = json.loads(good.read_text())
    for col in ("sel", "slot", "mb", "down_mb", "down_valid", "up_mb",
                "up_valid", "loss", "embed", "turn_rd", "turn_wr",
                "down_send", "up_send", "down_slot", "up_slot", "rx_slot",
                "turn_wr_slot", "turn_rd_slot", "skip_wr", "skip_wr_slot",
                "skip_rd_slot"):
        row = doc["tables"][col][1]
        row[3], row[4] = row[4], row[3]
    bad.write_text(json.dumps(doc))
    assert verify.main(["--plan", str(good)]) == 0
    assert verify.main(["--plan", str(bad)]) == 1


# ---------------------------------------------------------------------------
# kernel_check: the rules, each on both sides
# ---------------------------------------------------------------------------

def _errors(report):
    return [f.detail for f in report.errors()]


def _warns(report):
    return [f.detail for f in report.findings if f.level == "warn"]


def test_kernel_check_imports_neither_torch_nor_jax():
    code = ("import sys, repro_torch.analysis.kernel_check\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('torch', 'jax', 'jaxlib')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("dtype,ok", [("float32", True), ("bfloat16", True),
                                      ("float16", False)])
def test_flash_dtype(dtype, ok):
    r = kc.check_flash_attention(1, 64, 64, 2, 2, 64, dtype=dtype)
    assert r.ok == ok
    if not ok:
        assert r.errors()[0].rule == "dtype"


@pytest.mark.parametrize("D", [8, 16, 32, 48, 64, 80, 96, 112, 128, 224,
                               256])
def test_flash_head_dims_and_routes(D):
    for dtype in ("float32", "bfloat16"):
        r = kc.check_flash_attention(2, 128, 128, 4, 2, D, dtype=dtype)
        assert r.ok == (D in kc.HEAD_DIMS), (D, dtype)
        if r.ok:
            want = ("wgmma" if dtype == "bfloat16"
                    and D in kc.WGMMA_HEAD_DIMS else "simt")
            assert r.tiling["route"] == want
            assert flash_ops.flash_route(getattr(torch, dtype), D) == want
        else:
            assert f"head dim {D}" in _errors(r)[0]


def test_flash_gqa_cache_window_and_tma_rules():
    ok = dict(dtype="bfloat16")
    assert kc.flash_attention_supported(1, 4096, 4096, 15, 5, 64, **ok)
    assert not kc.flash_attention_supported(1, 64, 64, 15, 4, 64, **ok)
    assert kc.flash_attention_supported(2, 1, 64, 4, 2, 64, q_offset=10,
                                        kv_valid_len=11, **ok)
    assert not kc.flash_attention_supported(2, 1, 64, 4, 2, 64,
                                            kv_valid_len=65, **ok)
    assert not kc.flash_attention_supported(2, 1, 64, 4, 2, 64,
                                            q_offset=-1, **ok)
    assert kc.flash_attention_supported(1, 64, 64, 2, 2, 64, window=1, **ok)
    # a window of 0 masks every key: the kernel writes zeros, and says so
    r = kc.check_flash_attention(1, 64, 64, 2, 2, 64, window=0, **ok)
    assert r.ok and "masks every key" in _warns(r)[0]
    # TMA needs aligned bases on the tensor-core route only
    r = kc.check_flash_attention(1, 64, 64, 2, 2, 64, bases_aligned=False,
                                 **ok)
    assert [f.rule for f in r.errors()] == ["tma"]
    assert "16-byte-aligned" in _errors(r)[0]
    assert kc.flash_attention_supported(1, 64, 64, 2, 2, 16,
                                        bases_aligned=False, **ok)
    # a query tile thinner than the route's rows runs, and says so
    assert _warns(kc.check_flash_attention(1, 1, 64, 2, 2, 64, **ok))
    assert not _warns(kc.check_flash_attention(1, 64, 64, 2, 2, 64, **ok))
    # the grid's y dimension: 65,535 query tiles
    assert kc.flash_attention_supported(1, 65_535 * 64, 64, 1, 1, 64, **ok)
    assert not kc.flash_attention_supported(1, 65_535 * 64 + 1, 64, 1, 1,
                                            64, **ok)
    for dims in ((0, 1, 1, 1, 1, 64), (1, 1, 1, 1, 0, 64)):
        assert not kc.flash_attention_supported(*dims, **ok)


def test_shared_memory_budget(monkeypatch):
    """Every route fits the H100's opt-in budget; under a smaller budget
    the largest tiles are refused first."""
    assert kc.SMEM_OPTIN == 232_448
    for D in kc.HEAD_DIMS:
        for dtype in kc.DTYPES:
            assert kc.flash_tiling(dtype, D)["smem_bytes"] <= kc.SMEM_OPTIN
    monkeypatch.setattr(kc, "SMEM_OPTIN", 100_000)
    r = kc.check_flash_attention(1, 64, 64, 1, 1, 224, dtype="bfloat16")
    assert [f.rule for f in r.errors()] == ["smem"]
    assert kc.flash_attention_supported(1, 64, 64, 1, 1, 128,
                                        dtype="bfloat16")
    assert kc.skip_concat_matmul_supported(128, 64, 64, dtype="bfloat16")
    assert not kc.gated_linear_scan_supported(1, 64, 256)   # 107,680 B
    assert kc.gated_linear_scan_supported(1, 64, 256, dtype_a="bfloat16",
                                          dtype_x="bfloat16")


@pytest.mark.parametrize("dtype,d,n,ok", [
    ("bfloat16", 1280, 1280, True), ("bfloat16", 12, 8, False),
    ("bfloat16", 16, 12, False), ("bfloat16", 8, 8, True),
    ("float32", 12, 7, True), ("float16", 16, 16, False)])
def test_skip_dtype_and_tma_strides(dtype, d, n, ok):
    r = kc.check_skip_concat_matmul(64, d, n, dtype=dtype)
    assert r.ok == ok
    if not ok and dtype == "bfloat16":
        assert "D % 8 == N % 8 == 0" in _errors(r)[0]


def test_skip_thin_last_tile_and_bases():
    bf = dict(dtype="bfloat16")
    # UViT-H's M = 516 = 4 x 128 + 4: runs, with a warning
    r = kc.check_skip_concat_matmul(516, 1280, 1280, **bf)
    assert r.ok and "516" in _warns(r)[0]
    for M in (512, 128 + 32, 100):
        assert not _warns(kc.check_skip_concat_matmul(M, 64, 64, **bf))
    assert _warns(kc.check_skip_concat_matmul(128 + 31, 64, 64, **bf))
    assert _warns(kc.check_skip_concat_matmul(64 + 4, 64, 64))   # fp32 64
    assert not kc.skip_concat_matmul_supported(64, 64, 64, bases_aligned=False,
                                               **bf)
    assert kc.skip_concat_matmul_supported(64, 64, 64, bases_aligned=False)
    assert kc.skip_concat_matmul_supported(65_535 * 128, 8, 8, **bf)
    assert not kc.skip_concat_matmul_supported(65_535 * 128 + 1, 8, 8, **bf)
    assert not kc.skip_concat_matmul_supported(0, 8, 8)


@pytest.mark.parametrize("a", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("x", ["float32", "bfloat16", "float16"])
def test_scan_dtype_pairs(a, x):
    ok = "float16" not in (a, x)
    for bwd in (False, True):
        assert kc.gated_linear_scan_supported(
            2, 4096, 5120, dtype_a=a, dtype_x=x, backward=bwd) == ok


def test_scan_chunks_grid_and_tma_rows():
    assert [kc.scan_tiling(a, a, b)["chunk"]
            for a in ("bfloat16", "float32") for b in (False, True)] == \
        [64, 64, 48, 32]
    assert kc.scan_tiling("float32", "bfloat16")["chunk"] == 64
    # R x channel tiles x chunks at most INT_MAX blocks
    r = kc.check_gated_linear_scan(2 ** 31 // 2 + 1, 96, 256)
    assert [f.rule for f in r.errors()] == ["grid"]
    assert kc.gated_linear_scan_supported(2 ** 31 // 2 - 1, 96, 256)
    # rows whose bytes are no multiple of 16 load without TMA: a warning
    assert _warns(kc.check_gated_linear_scan(1, 8, 3))
    assert not _warns(kc.check_gated_linear_scan(1, 8, 4))
    assert _warns(kc.check_gated_linear_scan(1, 8, 4, dtype_a="bfloat16"))
    assert not kc.gated_linear_scan_supported(1, 0, 4)


def _constants(name):
    text = (CSRC / name).read_text()
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+)(?: \* 1024)?;", text)} | {
        k: int(v) * 1024 for k, v in re.findall(
            r"constexpr int (\w+) = (\d+) \* 1024;", text)}


def test_tilings_are_the_kernels_constants():
    """The tiles and shared memory the checks predict are computed from
    the constants the ``.cu`` files define (on the card, chip_smoke.py's
    ``kernel_check`` phase also holds them to each kernel's own report)."""
    f = _constants("flash_attention.cu")
    t = kc.flash_tiling("bfloat16", 128)
    assert (t["query_rows"], t["keys_per_tile"], t["stages"],
            t["threads"]) == (f["FBQ"], f["FBKV"], f["FSTAGES"],
                              f["FTHREADS"])
    t = kc.flash_tiling("float32", 128)
    assert (t["query_rows"], t["keys_per_tile"], t["threads"]) == (
        f["NWARP"] * f["ROWS"], f["BKV"], f["NWARP"] * 32)
    s = _constants("skip_matmul.cu")
    t = kc.skip_tiling("bfloat16")
    assert (t["tile_m"], t["tile_n"], t["k_step"], t["stages"]) == (
        s["SBM"], s["SBN"], s["SBK"], s["SSTAGES"])
    assert t["threads"] == s["SCONSUMER_WARPS"] * 32 + 32
    assert t["smem_bytes"] == s["SSTAGES"] * (
        s["SBM"] * s["SBK"] * 2 + s["SBK"] * s["SBN"] * 2) \
        + 2 * s["SSTAGES"] * 8 + 1024
    c = _constants("linear_scan.cu")
    t = kc.scan_tiling("bfloat16", "bfloat16")
    assert (t["channels"], t["threads"]) == (
        c["TILE_C"], c["WARPS"] * 32 + 32)
    assert c["TILE_BUDGET"] == 96 * 1024 and c["MAX_L"] == 64
    assert flash_ops.HEAD_DIMS is kc.HEAD_DIMS
    assert flash_ops.WGMMA_HEAD_DIMS is kc.WGMMA_HEAD_DIMS


# ---------------------------------------------------------------------------
# the wrappers take their verdicts from kernel_check
# ---------------------------------------------------------------------------

def _refusing(name):
    def check(*a, **k):
        return kc.KernelCheckReport(name, {}, (kc.KernelFinding(
            "error", "planted refusal"),))
    return check


@pytest.mark.parametrize("attr,call", [
    ("check_flash_attention", lambda: flash_ops.flash_attention_cuda(
        *(torch.zeros(1, 4, 2, 16),) * 3)),
    ("check_skip_concat_matmul", lambda: skip_ops.skip_concat_matmul_cuda(
        torch.zeros(4, 8), torch.zeros(4, 8), torch.zeros(16, 8))),
    ("check_gated_linear_scan", lambda: scan_ops.gated_linear_scan_cuda(
        torch.zeros(1, 4, 8), torch.zeros(1, 4, 8)))])
def test_wrappers_raise_the_predicates_verdict(monkeypatch, attr, call):
    """Each wrapper asks kernel_check: a refusal planted there is what it
    raises, before it looks at the device or launches."""
    monkeypatch.setattr(kc, attr, _refusing(attr))
    before = launch_counts()
    with pytest.raises(ValueError, match="planted refusal"):
        call()
    assert launch_counts() == before


def test_refused_shapes_raise_before_any_launch():
    before = launch_counts()
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="not a multiple of Hkv"):
        flash_ops.flash_attention_cuda(torch.zeros(1, 4, 6, 16),
                                       *(torch.zeros(1, 4, 4, 16),) * 2)
    with pytest.raises(ValueError, match="kv_valid_len"):
        flash_ops.flash_attention_cuda(*(torch.zeros(1, 4, 2, 16),) * 3,
                                       kv_valid_len=5)
    with pytest.raises(ValueError, match="D % 8 == N % 8 == 0"):
        skip_ops.skip_concat_matmul_cuda(
            torch.zeros(4, 16, dtype=bf), torch.zeros(4, 16, dtype=bf),
            torch.zeros(32, 12, dtype=bf))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        half = torch.zeros(4, 8, dtype=torch.half)
        skip_ops.skip_concat_matmul_cuda(half, half,
                                         torch.zeros(16, 8, dtype=torch.half))
    assert launch_counts() == before


# ---------------------------------------------------------------------------
# lint
# ---------------------------------------------------------------------------

def _lint_snippet(tmp_path, rel, src):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(src))
    return [f.rule for f in lint.lint_file(path)]


def test_lint_port_boundary(tmp_path):
    for src in ("import jax\n", "import jax.numpy as jnp\n",
                "from jaxlib import xla_client\n",
                "from repro.core.graph import Block\n", "import repro\n",
                "def f():\n    from repro.models import lm\n"):
        assert _lint_snippet(tmp_path, "repro_torch/runtime/foo.py",
                             src) == ["port-boundary"], src
        assert _lint_snippet(tmp_path, "chip_smoke.py", src) == \
            ["port-boundary"], src
        assert _lint_snippet(tmp_path, "tests/test_torch_gpu.py", src) == \
            ["port-boundary"], src
        # other tests compare the two packages: not covered
        assert _lint_snippet(tmp_path, "tests/test_torch_lm.py", src) == []
    for src in ("import repro_torch.core.graph\n",
                "from repro_torch import tree\n", "import torch\n",
                "from . import ring\n"):
        assert _lint_snippet(tmp_path, "repro_torch/runtime/foo.py",
                             src) == [], src


def test_lint_core_lazy_torch(tmp_path):
    core = "repro_torch/core/foo.py"
    assert _lint_snippet(tmp_path, core, "import torch\n") == \
        ["core-lazy-torch"]
    assert _lint_snippet(tmp_path, core, "import torch.nn as nn\n") == \
        ["core-lazy-torch"]
    assert _lint_snippet(tmp_path, core,
                         "from torch.utils import checkpoint\n") == \
        ["core-lazy-torch"]
    assert _lint_snippet(tmp_path, core, """
        def f():
            import torch
            return torch
    """) == []
    assert _lint_snippet(tmp_path, core, """
        from typing import TYPE_CHECKING
        if TYPE_CHECKING:
            import torch
    """) == []
    assert _lint_snippet(tmp_path, "repro_torch/runtime/foo.py",
                         "import torch\n") == []


def test_lint_guarded_placement_extrema(tmp_path):
    sched = "repro_torch/core/schedule.py"
    assert _lint_snippet(tmp_path, sched, """
        def makespan(self):
            return max(p.step for p in self.placements)
    """) == ["guarded-placement-extrema"]
    assert _lint_snippet(tmp_path, sched, """
        def makespan(self):
            if not self.placements:
                raise ValueError("empty")
            return max(p.step for p in self.placements)
    """) == []
    assert _lint_snippet(tmp_path, sched, """
        def makespan(self):
            return max((p.step for p in self.placements), default=0)
    """) == []
    assert _lint_snippet(tmp_path, "repro_torch/core/other.py", """
        def f(placements):
            return max(p.step for p in placements)
    """) == []


def test_port_tree_is_policy_clean():
    paths = [REPO / p for p in lint.DEFAULT_PATHS]
    assert all(p.exists() for p in paths)
    findings = lint.lint_paths(paths)
    assert findings == [], "\n".join(str(f) for f in findings)


def test_lint_cli(tmp_path):
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint"],
                          cwd=REPO, env=_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s) in 3 path(s)" in proc.stdout
    bad = tmp_path / "repro_torch" / "core" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import torch\nimport jax\n")
    assert lint.main([str(bad)]) == 1
    assert lint.main([str(tmp_path / "missing.py")]) == 2

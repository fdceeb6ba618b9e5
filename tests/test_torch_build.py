"""The kernel build's file lock: processes that build into one directory at
once (the ranks of one ``torchrun``) take turns, and a library one of them
built is loaded, not built again, by the others.  The compiler is a stub
that logs when it starts and ends and writes its ``-o`` file."""
import os
import pathlib
import stat
import subprocess
import sys
import textwrap

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]

STUB = textwrap.dedent("""\
    #!{python}
    import os, sys, time
    log = os.environ["STUB_NVCC_LOG"]
    out = sys.argv[sys.argv.index("-o") + 1]
    with open(log, "a") as f:
        f.write(f"start {{os.getpid()}} {{time.time()}} {{out}}\\n")
    time.sleep(1.0)
    with open(out, "wb") as f:
        f.write(b"stub")
    with open(log, "a") as f:
        f.write(f"end {{os.getpid()}} {{time.time()}}\\n")
    """)

BUILD = ("import json, sys; from repro_torch.kernels import build; "
         "print(json.dumps(sorted(build.build(tuple(sys.argv[1:])))))")


def _build_together(tmp_path, names_a, names_b) -> tuple[list, list]:
    cuda = tmp_path / "cuda" / "bin"
    cuda.mkdir(parents=True)
    nvcc = cuda / "nvcc"
    nvcc.write_text(STUB.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / "nvcc.log"
    env = dict(os.environ, CUDA_HOME=str(tmp_path / "cuda"),
               REPRO_TORCH_BUILD_DIR=str(tmp_path / "build"),
               STUB_NVCC_LOG=str(log), PYTHONPATH=str(REPO / "src"))
    env.pop("REPRO_TORCH_NO_BUILD", None)
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, *names],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for names in (names_a, names_b)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-3000:]
        outs.append(out.strip().splitlines()[-1])
    events = [line.split() for line in log.read_text().splitlines()]
    return outs, events


def _intervals(events) -> list[tuple[float, float]]:
    """(start, end) of each compiler process."""
    start = {e[1]: float(e[2]) for e in events if e[0] == "start"}
    end = {e[1]: float(e[2]) for e in events if e[0] == "end"}
    return sorted((start[p], end[p]) for p in start)


def test_two_builds_of_one_library_compile_it_once(tmp_path):
    outs, events = _build_together(tmp_path, ["skip_matmul"],
                                   ["skip_matmul"])
    # one process compiled it; the other waited, then found it built
    assert sorted(outs) == ['["skip_matmul"]', "[]"], outs
    assert [e[0] for e in events] == ["start", "end"]
    from repro_torch.kernels import build
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(tmp_path / "build")
    try:
        assert build.lib_path("skip_matmul").read_bytes() == b"stub"
    finally:
        del os.environ["REPRO_TORCH_BUILD_DIR"]


@pytest.mark.parametrize("names_b", [["flash_attention"],
                                     ["flash_attention", "linear_scan"]])
def test_builds_into_one_directory_take_turns(tmp_path, names_b):
    outs, events = _build_together(tmp_path, ["skip_matmul"], names_b)
    assert sorted(outs) == sorted(['["skip_matmul"]',
                                   str(sorted(names_b)).replace("'", '"')])
    spans = _intervals(events)
    assert len(spans) == 1 + len(names_b)
    # the compilers of one build run together; the two builds never overlap
    first = [s for s in spans if s[0] < spans[0][1]]
    second = [s for s in spans if s not in first]
    assert first and second
    assert max(e for _, e in first) <= min(s for s, _ in second)

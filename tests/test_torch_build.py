"""The pure-Python parts of the CUDA build helper (no nvcc needed)."""

import pytest

from pyneuralempc_tpu_torch.ops.cuda import build

import _torch_threads  # noqa: F401  (one torch thread)


def test_library_path_follows_source_and_flags(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// a\n")
    p1 = build.library_path(src)
    assert p1.parent == build.BUILD_DIR
    assert p1.name.startswith("libk_") and p1.suffix == ".so"
    assert build.library_path(src) == p1                 # stable
    assert build.library_path(src, flags=("-O2",)) != p1
    src.write_text("// b\n")
    assert build.library_path(src) != p1                 # edited source


def test_nvcc_command_targets_hopper(tmp_path):
    cmd = build.nvcc_command("nvcc", tmp_path / "k.cu", tmp_path / "k.so")
    assert cmd[0] == "nvcc" and cmd[-1].endswith("k.cu")
    assert cmd[-3:-1] == ["-o", str(tmp_path / "k.so")]
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and "-fPIC" in cmd


def test_find_nvcc_reports_a_missing_toolkit(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("")
    assert build.find_nvcc() == str(fake)


def test_library_path_follows_the_headers(tmp_path, monkeypatch):
    """A source may include any header beside it, so an edited, added or
    removed header gives every source a new library path."""
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text('#include "h.cuh"\n')
    header = tmp_path / "h.cuh"
    header.write_text("// a\n")
    p1 = build.library_path(src)
    assert build.library_path(src) == p1                 # stable
    header.write_text("// b\n")
    p2 = build.library_path(src)
    assert p2 != p1                                      # edited header
    (tmp_path / "g.cuh").write_text("// g\n")
    p3 = build.library_path(src)
    assert p3 not in (p1, p2)                            # added header
    (tmp_path / "g.cuh").unlink()
    assert build.library_path(src) == p2                 # removed again
    (tmp_path / "notes.txt").write_text("x")
    assert build.library_path(src) == p2                 # not a header


def test_sources_ship_in_the_package():
    assert (build.CSRC_DIR / "riccati_sweep.cu").is_file()
    text = (build.CSRC_DIR / "riccati_sweep.cu").read_text()
    assert 'extern "C" int riccati_sweep_f32' in text
    text = (build.CSRC_DIR / "riccati_streamed.cu").read_text()
    assert 'extern "C" int riccati_backward_f32' in text
    assert 'extern "C" int riccati_backward_runtime_f32' in text
    assert 'extern "C" int riccati_forward_f32' in text
    # the backward template both streamed sources instantiate
    header = build.CSRC_DIR / "riccati_backward_fixed.cuh"
    assert "riccati_general_backward_fixed(" in header.read_text()
    for source in ("riccati_streamed.cu", "riccati_general.cu"):
        text = (build.CSRC_DIR / source).read_text()
        assert '#include "riccati_backward_fixed.cuh"' in text
    setup = (build.PACKAGE_DIR.parent / "setup.py").read_text()
    assert '"csrc/*.cu", "csrc/*.cuh"' in setup


def _fake_nvcc(tmp_path, rc=0):
    """A stand-in for nvcc that writes its ``-o`` file and a ptxas line."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    "while [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then echo lib > \"$2\"; fi\n"
                    "  shift\n"
                    "done\n"
                    "echo 'ptxas info    : Used 56 registers'\n"
                    f"exit {rc}\n")
    fake.chmod(0o755)
    return str(fake)


def test_build_runs_nvcc_once_then_reuses_the_library(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "find_nvcc", lambda: _fake_nvcc(tmp_path))
    src = tmp_path / "k.cu"
    src.write_text("// k\n")
    first = build.build(src)
    assert first.path == build.library_path(src) and first.path.is_file()
    assert "registers" in first.log and first.seconds > 0
    assert list(first.path.parent.iterdir()) == [first.path]   # no temp
    again = build.build(src)
    assert again.path == first.path and again.seconds == 0.0


def test_build_raises_with_nvcc_output(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "find_nvcc",
                        lambda: _fake_nvcc(tmp_path, rc=2))
    src = tmp_path / "k.cu"
    src.write_text("// k\n")
    with pytest.raises(RuntimeError, match="exit 2"):
        build.build(src)
    assert not build.library_path(src).exists()


def test_load_builds_and_opens_a_library_once(tmp_path, monkeypatch):
    """After the first load, a launch touches neither nvcc nor the disk."""
    builds, opened = [], []
    result = build.BuildResult(tmp_path / "libk.so", 0.0, "")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "build",
                        lambda src: builds.append(src) or result)
    monkeypatch.setattr(build.ctypes, "CDLL",
                        lambda path: opened.append(path) or object())
    lib = build.load("k.cu")
    assert build.load("k.cu") is lib and build.load("k.cu") is lib
    assert builds == [tmp_path / "k.cu"]
    assert opened == [str(result.path)]


def test_build_all_starts_every_nvcc_at_once(tmp_path, monkeypatch):
    """Each stand-in nvcc waits until both have started: run one after the
    other, the first would give up (exit 3) and the build would raise."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    marks = tmp_path / "started"
    marks.mkdir()
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    "out=''\n"
                    "while [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then out=\"$2\"; fi\n"
                    "  shift\n"
                    "done\n"
                    f"touch {marks}/$$\n"
                    "n=0\n"
                    f"while [ $(ls {marks} | wc -l) -lt 2 ]; do\n"
                    "  n=$((n+1)); [ $n -gt 200 ] && exit 3; sleep 0.05\n"
                    "done\n"
                    "echo lib > \"$out\"\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "find_nvcc", lambda: str(fake))
    srcs = [tmp_path / "a.cu", tmp_path / "b.cu"]
    for s in srcs:
        s.write_text(f"// {s.name}\n")
    results = build.build_all(srcs)
    assert [r.path for r in results] == [build.library_path(s) for s in srcs]
    assert all(r.path.is_file() and r.seconds > 0 for r in results)
    again = build.build_all(srcs)          # built: no nvcc at all
    assert [r.seconds for r in again] == [0.0, 0.0]

"""The kernel build's parts (mila_tpu_torch/kernels/_build.py: PARTS), on the
CPU: a fake nvcc records each command and writes its output file, so the
commands, the link and the clean-up are checked without a CUDA toolkit."""

import re
import stat
import sys

import pytest

from mila_tpu_torch.kernels import _build

FAKE_NVCC = """#!{python}
import json, os, sys
args = sys.argv[1:]
with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
    f.write(json.dumps(args) + "\\n")
if os.environ.get("FAKE_NVCC_FAIL", "-") in args:
    sys.exit(3)
open(args[args.index("-o") + 1], "w").close()
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    exe = tmp_path / "nvcc"
    exe.write_text(FAKE_NVCC.format(python=sys.executable))
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / "calls.jsonl"
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setattr(_build, "nvcc", lambda: str(exe))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")

    def calls():
        import json

        return [json.loads(line) for line in log.read_text().splitlines()]

    return calls


@pytest.mark.parametrize("name", sorted(_build.PARTS))
def test_parts_compile_apart_then_link(fake_nvcc, name):
    _build.build_all((name,))
    calls = fake_nvcc()
    n = _build.PARTS[name]
    compiles, link = calls[:n], calls[n]
    assert len(calls) == n + 1
    assert sorted(a for c in compiles for a in c if a.startswith("-DMILA_PART=")) == [
        f"-DMILA_PART={k}" for k in range(n)]
    for c in compiles:
        assert "-c" in c and "-shared" not in c and c[-1].endswith(f"{name}.cu")
    objs = sorted(c[c.index("-o") + 1] for c in compiles)  # the fake logs them as they run
    assert link[:2] == ["-shared", "-o"] and sorted(link[3:]) == objs
    lib = _build.lib_path(name)
    assert lib.exists() and str(lib) != link[2]
    assert not any(p.suffix == ".o" or p.suffix == ".tmp" for p in lib.parent.iterdir())
    _build.build_all((name,))  # built: no nvcc again
    assert len(fake_nvcc()) == n + 1


def test_a_failed_part_fails_the_build(fake_nvcc, monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_FAIL", "-DMILA_PART=2")
    with pytest.raises(RuntimeError, match=r"decode_step_int8\.cu \(rc 3"):
        _build.build_all(("decode_step_int8",))
    assert len(fake_nvcc()) == _build.PARTS["decode_step_int8"]  # every part ran; no link
    assert not _build.lib_path("decode_step_int8").exists()
    assert not any(p.suffix == ".o" for p in _build.BUILD_DIR.iterdir())


def test_single_sources_build_whole(fake_nvcc):
    _build.build_all(("fused_adamw",))
    (call,) = fake_nvcc()
    assert call[:len(_build.NVCC_FLAGS)] == _build.NVCC_FLAGS and "-c" not in call
    assert not any(a.startswith("-DMILA_PART") for a in call)


@pytest.mark.parametrize("name", sorted(_build.PARTS))
def test_each_part_holds_code(name):
    # Every part the build compiles is named in the source, and no other.
    text = (_build.CSRC / f"{name}.cu").read_text() + (_build.CSRC / "common.cuh").read_text()
    named = {int(k) for k in re.findall(r"IN_PART\((\d+)\)", text)}
    assert named == set(range(_build.PARTS[name]))


@pytest.mark.parametrize("name,part,entry", [
    ("flash_fwd", 1, "run_bf16"), ("flash_fwd", 2, "run_f16"),
    ("flash_fwd", 3, "run_bf16_wide"), ("flash_fwd", 4, "run_f16_wide"),
    ("flash_fwd", 5, "run_bf16_part"), ("flash_fwd", 6, "run_f16_part"),
    ("flash_tf32_fwd", 3, "run_part"),
    ("flash_sync_bwd", 1, "run_f32"), ("flash_bwd", 5, "dkv_part_bf16"),
    ("flash_bwd", 6, "dkv_part_f16"), ("flash_bwd", 7, "dq_part_bf16"),
    ("flash_bwd", 8, "dq_part_f16"),
    ("flash_tf32_bwd", 1, "run_d64"), ("flash_tf32_bwd", 2, "run_d128"),
])
def test_flash_parts_split_the_instantiations(name, part, entry):
    # The flash sources' heavy instantiations compile in parts of their own:
    # the wgmma forward's D 192/256 kernels apart from D 64/128 per type and
    # its kernels past D 256 apart from both, the tf32 forward's past D 256, the
    # f32 backward's split kernels apart from its C entry, the 16-bit
    # backward's dK/dV and dQ kernels past D 256 apart from each other per
    # type, the tf32 backward's D 64 apart from its D 128. Each entry is
    # defined in the #if block of its part.
    text = (_build.CSRC / f"{name}.cu").read_text()
    block = re.search(rf"#if IN_PART\({part}\)\n(.*?)#endif", text, re.S)
    assert block is not None and f"::{entry}(const Call& c)" in block.group(1)

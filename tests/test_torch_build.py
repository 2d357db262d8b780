"""How the port's CUDA kernels are built, checked on the CPU: the library
name follows the shared headers as well as the source, both build
commands (``kernels/_build.py`` and ``chip_smoke.py``'s planted faults)
put ``csrc/`` on the include path, and every planted fault of
``chip_smoke.py`` names a line its kernel source holds exactly once;
``chip_smoke.py --against`` builds another version of a kernel source, and
its build phase reads ptxas's report of each function and holds the bf16
flash kernels' SASS to wgmma and TMA.
No nvcc is run: the commands are recorded, not executed."""
import importlib.util
import re
import subprocess
from pathlib import Path

import pytest

from repro_torch.kernels import _build

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_library_path_follows_the_headers(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    src, hdr = csrc / "k.cu", csrc / "h.cuh"
    src.write_text('#include "h.cuh"\n')
    hdr.write_text("// v1\n")
    first = _build._lib_path(src)
    assert first.parent == _build.BUILD_DIR and first.name.startswith("libk-")
    hdr.write_text("// v2\n")
    assert _build._lib_path(src) != first          # an edited header rebuilds
    hdr.write_text("// v1\n")
    assert _build._lib_path(src) == first          # an unchanged tree reloads
    (csrc / "new.cuh").write_text("// another\n")
    assert _build._lib_path(src) != first          # so does a new header
    (csrc / "new.cuh").unlink()
    src.write_text('#include "h.cuh"\n// edited\n')
    assert _build._lib_path(src) != first


class _FakeNvcc:
    """Stands in for subprocess.Popen: records the command and writes an
    empty library where nvcc's ``-o`` points."""
    commands = []

    def __init__(self, cmd, **_):
        self.commands.append(list(cmd))
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        self.returncode = 0

    def communicate(self):
        return "", None


def _has_include(cmd):
    return any(a == "-I" and b == str(_build.CSRC) for a, b in zip(cmd, cmd[1:]))


def test_both_build_commands_put_csrc_on_the_include_path(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", _FakeNvcc)
    monkeypatch.setattr(_FakeNvcc, "commands", [])
    _build.build_all()
    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert sorted(Path(c[-1]).name for c in _FakeNvcc.commands) == sources
    assert all(_has_include(c) for c in _FakeNvcc.commands)

    monkeypatch.setattr(_FakeNvcc, "commands", [])
    cs = _chip_smoke()
    procs = cs.start_fault_builds()
    assert set(procs) == set(range(len(cs.FAULTS)))     # one build per planted fault
    for cmd in _FakeNvcc.commands:
        # the faulty copy lies outside csrc/: only the flag finds the headers
        assert Path(cmd[-1]).parent == tmp_path / "kernels" / "faults"
        assert _has_include(cmd)


def test_every_include_names_a_header_in_csrc():
    headers = {p.name for p in _build.CSRC.glob("*.cuh")}
    assert "hopper.cuh" in headers
    for src in _build.CSRC.glob("*.cu"):
        for inc in re.findall(r'^#include "([^"]+)"', src.read_text(), re.M):
            assert inc in headers, (src.name, inc)


def test_planted_faults_hold_their_lines_once_and_cover_every_kernel():
    cs = _chip_smoke()
    for name, kernels, bug, old, new in cs.FAULTS:
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert text.count(old) == 1, (name, bug, old)
        assert new != old and text.replace(old, new).count(new) == 1
        assert set(kernels) <= set(cs.KERNELS)
    covered = {k for f in cs.FAULTS for k in f[1]}
    assert covered == set(cs.KERNELS)


def test_flash_cases_are_valid_shapes():
    """Each gate case is a shape the wrapper takes (D 64 / 128, H a
    multiple of Hkv, window >= 1)."""
    for case in _chip_smoke().FLASH_CASES:
        B, S, H, Hkv, D, causal, window, softcap = case
        assert B >= 1 and S >= 1 and H % Hkv == 0 and D in (64, 128), case
        assert window is None or window >= 1, case


def test_flash_bwd_cases_are_valid_shapes_and_cover_the_tile_edges():
    """Each backward gate case is a shape the wrapper takes, and the bf16
    body's tile edges (S 63-65, 127, 129, 511, 513 against 64-row tiles
    and 128-row blocks) are each held at D 64 and 128, causal and not, rep
    1 and 4."""
    cases = _chip_smoke().FLASH_BWD_CASES
    for case in cases:
        B, S, H, Hkv, D, causal = case
        assert B >= 1 and S >= 1 and H % Hkv == 0 and D in (64, 128), case
        assert isinstance(causal, bool), case
    for S in (63, 64, 65, 127, 129, 511, 513):
        at = [c for c in cases if c[1] == S]
        assert {c[4] for c in at} == {64, 128}, S
        assert {c[5] for c in at} == {True, False}, S
        assert {c[2] // c[3] for c in at} >= {1, 4}, S


_SASS = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_115dq_wgmma_kernelILi64ELb0EEEvN6ParamsE
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0180*/                   UTMALDG.4D [UR8], [UR4] ;                            /* 0x0000000408 */
        /*0b40*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;  /* 0x0000000418 */
        /*0c10*/                   UTMASTG.4D [UR4], [UR6] ;                            /* 0x0000000406 */
		Function : _ZN12_GLOBAL__N_117dkdv_wgmma_kernelILi64ELb1EEEvN6ParamsE
        /*0180*/                   UTMALDG.4D [UR8], [UR4] ;                            /* 0x0000000408 */
        /*0b40*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;  /* 0x0000000418 */
		Function : _ZN12_GLOBAL__N_115dq_f32_kernelIfLi64EEEvN6ParamsE
        /*0200*/                   FFMA R4, R5, R6, R4 ;                                /* 0x0000000604 */
"""


def test_wgmma_route_check_reads_canned_sass():
    """The build phase's check that the bf16 flash kernels run on wgmma
    and TMA alone: it passes SASS with HGMMA and UTMALDG, and fails SASS
    where a function lacks either, holds HMMA, or is missing."""
    cs = _chip_smoke()
    sass = cs.parse_sass(_SASS)
    assert sass["_ZN12_GLOBAL__N_115dq_wgmma_kernelILi64ELb0EEEvN6ParamsE"] == {
        "HGMMA": 1, "UTMALDG": 1, "UTMASTG": 1, "HMMA": 0}
    assert cs.wgmma_route_faults(sass, "dq_wgmma") == []
    assert cs.wgmma_route_faults(sass, "dkdv_wgmma") == []
    assert cs.wgmma_route_faults(sass, "flash_fwd_wgmma") == ["no function named flash_fwd_wgmma"]
    assert len(cs.wgmma_route_faults(sass, "dq_f32")) == 1         # no HGMMA, no UTMALDG
    for broken in (_SASS.replace("UTMALDG", "LDG.E.128"),
                   _SASS.replace("HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4]", "NOP"),
                   _SASS.replace("UTMASTG.4D", "HMMA.16816.F32.BF16")):
        faults = cs.wgmma_route_faults(cs.parse_sass(broken), "dq_wgmma")
        assert len(faults) == 1 and "dq_wgmma" in faults[0], broken


def test_wgmma_functions_name_kernels_of_their_sources():
    for name, part in _chip_smoke().WGMMA_FUNCTIONS:
        text = (_build.CSRC / f"{name}.cu").read_text()
        # a kernel's declaration: no ";" or "{" between __global__ and its name
        assert re.search(rf"__global__ void[^;{{]*\b{part}\w*\(", text), (name, part)


def test_against_builds_name_a_kernel_and_find_the_headers(tmp_path, monkeypatch):
    """``chip_smoke.py --against NAME=SOURCE``: SOURCE stands for the
    kernel source of its file name, is built outside csrc/ with csrc/ on
    the include path, and a bad option fails before anything is built."""
    cs = _chip_smoke()
    old = tmp_path / "parent" / "flash_attention.cu"
    old.parent.mkdir()
    old.write_text((_build.CSRC / "flash_attention.cu").read_text())
    against = cs.parse_against([f"parent={old}"])
    assert against == [("parent", "flash_attention", old.resolve())]
    other = tmp_path / "not_a_kernel.cu"
    other.write_text("")
    for bad in ([f"checkout={old}"], [f"parent={old}", f"parent={old}"], [f"x={other}"],
                [f"x={tmp_path / 'flash_attention.cu'}"], [f"={old}"]):
        with pytest.raises(SystemExit):
            cs.parse_against(bad)

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", _FakeNvcc)
    monkeypatch.setattr(_FakeNvcc, "commands", [])
    procs = cs.start_against_builds(against)
    assert list(procs) == ["parent"]
    (cmd,) = _FakeNvcc.commands
    assert Path(cmd[-1]) == old.resolve() and _has_include(cmd)
    assert procs["parent"][1] == tmp_path / "kernels" / "against" / "libflash_attention-parent.so"


def test_ptxas_report_keeps_each_functions_registers_spills_and_warnings():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Function properties for _Z9store_lsev
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_Z6kernelILi64EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi64EEvv
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 16 barriers
ptxas info    : Compile time = 1006.340 ms
ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async instructions are serialized
ptxas warning : Registers are spilled to local memory in function '_Z6kernelILi64EEvv'
"""
    assert _chip_smoke().ptxas_report(log) == {
        "warnings": ["ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async "
                     "instructions are serialized",
                     "ptxas warning : Registers are spilled to local memory in function "
                     "'_Z6kernelILi64EEvv'"],
        "_Z9store_lsev": ["0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"],
        "_Z6kernelILi64EEvv": ["8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
                               "ptxas info    : Used 128 registers, used 16 barriers"]}

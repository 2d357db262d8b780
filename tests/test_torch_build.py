"""How the port's CUDA kernels are built, checked on the CPU: the library
name follows the shared headers as well as the source, both build
commands (``kernels/_build.py`` and ``chip_smoke.py``'s planted faults)
put ``csrc/`` on the include path, and every planted fault of
``chip_smoke.py`` names a line its kernel source holds exactly once;
``chip_smoke.py --against`` builds another version of a kernel source, and
its build phase reads ptxas's report of each function and holds the bf16
product kernels' SASS to wgmma and TMA.  The SSD and paged-attention gate
cases reach every edge of their bf16 bodies under the wrappers' shape
rules, and the SSD bound counts the products the function needs.
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


def _kernel_bodies(text):
    """{name of each __global__ function: its text up to the next one}."""
    starts = [(m.start(), m.group(1)) for m in
              re.finditer(r"__global__ void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(",
                          text)]
    return {name: text[s:e] for (s, name), (e, _) in zip(starts, starts[1:] + [(len(text), "")])}


def _device_body(text, name):
    """The text of the device function ``name`` (a kernel's body shared by
    its bf16 and f32 kernels), up to its closing brace at column 0."""
    start = re.search(rf"void {name}\(", text).start()
    return text[start:text.index("\n}\n", start)]


def test_planted_faults_hold_their_lines_once_and_cover_every_kernel():
    """Each fault's line is in its source once; the faults cover every
    kernel of the gate, each pass of the bf16 SSD body (its product
    passes and the carry) holds a fault of its own, and the paged body on
    wgmma holds two beside the combine's one.  Each f32 flash body (the
    forward, dq, dkdv, the D-256 backward's forming of its resident
    tile's pieces and its dV block) holds one fault read in f32 that keeps
    only the first bf16 piece of one of its operands; the f32 SSD body's
    out pass one that keeps map(S)'s first two pieces, and its carry one
    that keeps state_in's first."""
    cs = _chip_smoke()
    for name, kernels, bug, old, new, dname in cs.FAULTS:
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert text.count(old) == 1, (name, bug, old)
        assert new != old and text.replace(old, new).count(new) == 1
        assert set(kernels) <= set(cs.KERNELS)
        assert dname in ("bfloat16", "float32")
        dropped = cs.F32_PIECES_DROPPED in new or cs.F32_THIRD_PIECE_DROPPED in new
        assert dropped == (dname == "float32"), bug
    f32 = [f for f in cs.FAULTS if f[5] == "float32"]
    for name, body in (("flash_attention", "fwd_body"), ("flash_attention_bwd", "dq_body"),
                       ("flash_attention_bwd", "dkdv_body"), ("flash_attention_bwd", "a_pieces"),
                       ("flash_attention_bwd", "dv_res_body")):
        text = _device_body((_build.CSRC / f"{name}.cu").read_text(), body)
        assert sum(f[0] == name and f[3] in text for f in f32) == 1, body
    covered = {k for f in cs.FAULTS for k in f[1]}
    assert covered == set(cs.KERNELS)
    bodies = _kernel_bodies((_build.CSRC / "ssd_scan.cu").read_text())
    ssd_faults = [f[3] for f in cs.FAULTS if f[0] == "ssd_scan" and f[5] == "bfloat16"]
    passes = [part for name, part in cs.WGMMA_FUNCTIONS
              if name == "ssd_scan" and "f32" not in part] + ["ssd_carry_kernel"]
    assert len(passes) == 3
    for part in passes + ["ssd_scan_kernel"]:
        (fn,) = [k for k in bodies if k.startswith(part)]
        assert sum(old in bodies[fn] for old in ssd_faults) == 1, part
    ssd_f32 = [f[3] for f in f32 if f[0] == "ssd_scan"]
    for part, n in (("ssd_out_f32_wgmma", 1), ("ssd_carry_pieces", 1), ("ssd_state_f32_wgmma", 0)):
        (fn,) = [k for k in bodies if k.startswith(part)]
        assert sum(old in bodies[fn] for old in ssd_f32) == n, part
    bodies = _kernel_bodies((_build.CSRC / "paged_attention.cu").read_text())
    paged_faults = [f[3] for f in cs.FAULTS if f[0] == "paged_attention"]
    for part, n in (("paged_wgmma", 2), ("paged_combine", 1), ("paged_partial", 0)):
        (fn,) = [k for k in bodies if k.startswith(part)]
        assert sum(old in bodies[fn] for old in paged_faults) == n, part


def test_flash_cases_are_valid_shapes():
    """Each gate case is a shape the wrapper takes (D 64 / 80 / 128 / 256,
    or MLA's 192 (v 128) causal without a softcap; H a multiple of Hkv,
    window >= 1); deepseek-v2-lite's train shape and ragged prefills of
    300 and 4000 are held at D 192; gemma3's serve and train shapes are
    held at D 256 with its window of 1024 and without, and gemma2's
    8192-token prefill (a head slice at rep 2) at D 128 with its window of
    4096 and without, its softcap 50 and query scale 144^-0.5."""
    cs = _chip_smoke()
    for case in cs.FLASH_CASES:
        B, S, H, Hkv, D, causal, window, softcap, *scale = case
        assert B >= 1 and S >= 1 and H % Hkv == 0 and D in (64, 80, 128, 192, 256), case
        assert D != 192 or (causal and not softcap and cs.v_dim(D) == 128), case
        assert window is None or window >= 1, case
        assert len(scale) <= 1 and all(0 < x < 1 for x in scale), case
    assert cs.DEEPSEEK_TRAIN_ATTN == (1, 4096, 16, 16, 192, True)
    mla = {c[1] for c in cs.FLASH_CASES if c[2:5] == (16, 16, 192)}
    assert {4096, 300, 4000} <= mla
    for shape in (cs.GEMMA_SERVE_ATTN, cs.GEMMA_TRAIN_ATTN):
        assert shape[4] == 256
        assert {c[6] for c in cs.FLASH_CASES if c[:6] == shape} == {1024, None}
    gemma2 = [c for c in cs.FLASH_CASES if c[:6] == cs.GEMMA2_PREFILL_SLICE]
    assert cs.GEMMA2_PREFILL_SLICE[1] == 8192 and cs.GEMMA2_PREFILL_SLICE[2:5] == (4, 2, 128)
    assert {c[6] for c in gemma2} == {4096, None}
    assert {c[7:] for c in gemma2} == {(50.0, 144.0**-0.5)}


def test_flash_bwd_cases_are_valid_shapes_and_cover_the_tile_edges():
    """Each backward gate case is a shape the wrapper takes, and the bf16
    body's tile edges (S 63-65, 127, 129, 511, 513 against 64-row tiles
    and 128-row blocks) are each held at D 64 and 128, causal and not, rep
    1 and 4."""
    cs = _chip_smoke()
    cases = cs.FLASH_BWD_CASES
    for case in cases:
        B, S, H, Hkv, D, causal = case[:6]
        window, softcap, amp, scale = cs.bwd_case_opts(case)
        assert B >= 1 and S >= 1 and H % Hkv == 0 and D in (64, 80, 128, 192, 256), case
        assert D != 192 or (causal and not softcap), case
        assert isinstance(causal, bool) and (window is None or window >= 1), case
        assert len(case) in (6, 7, 9) and amp >= 1, case
        assert (scale is None) == (softcap == 0.0), case
    windowed = [c for c in cases if len(c) > 6 and c[6] is not None]
    assert {c[4] for c in windowed} == {64, 128, 192, 256}
    mla = {c[1] for c in cases if c[2:5] == (16, 16, 192)}
    assert cs.DEEPSEEK_TRAIN_ATTN in cases and {4096, 300, 4000} <= mla
    assert {c[5] for c in windowed} == {True, False}
    assert cs.GEMMA_TRAIN_ATTN + (1024,) in cases and cs.GEMMA_TRAIN_ATTN in cases
    for S in (63, 64, 65, 127, 129, 511, 513):
        at = [c for c in cases if c[1] == S]
        assert {c[4] for c in at} == {64, 128}, S
        assert {c[5] for c in at} == {True, False}, S
        assert {c[2] // c[3] for c in at} >= {1, 4}, S


def test_flash_bwd_softcap_cases_reach_gemma2_and_the_caps_saturation():
    """The softcap cases are all at head dim 128, causal, rep 2 (what the
    softcap bodies are built for, gemma2-27b's attention); they hold
    gemma2's heads (32 / 16) at S 4352, past its window of 4096, windowed
    and global at cap 50, the bodies' tile edges (S 31, 63, 65, 129 against
    32- and 64-row tiles), a window crossing 128-key tiles, and a case
    whose scores saturate the cap (q drawn times 4 at cap 1)."""
    cs = _chip_smoke()
    capped = [c for c in cs.FLASH_BWD_CASES if cs.bwd_case_opts(c)[1]]
    assert capped and all(c[4] == 128 and c[5] and c[2] // c[3] == 2 for c in capped)
    gemma2 = [c for c in capped if c[2:4] == (32, 16)]
    assert {(c[1], c[6], c[7]) for c in gemma2} == {(4352, 4096, 50.0), (4352, None, 50.0)}
    assert {31, 63, 65, 129} <= {c[1] for c in capped}
    assert any(c[6] and c[6] % 128 and c[1] > 2 * c[6] for c in capped)
    assert any(c[8] / c[7] >= 4 for c in capped)


def test_flash_bwd_softcap_is_a_template_choice_of_both_passes():
    """The softcap backward is the compile-time choice CAP of the dq and
    dkdv bodies, with the accurate tanhf (no tanh.approx) and 1 - t^2 as
    one fma in each; the C entry takes it last; the launch builds it at
    the head dims of ``BWD_SOFTCAP_HEAD_DIMS``, causal, and the wrapper
    refuses the softcap at every other head dim and when not causal,
    before it looks at the device."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    text = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    for body in ("dq_body", "dkdv_body"):
        src = _device_body(text, body)
        assert re.search(rf"bool CAP>\s*__device__ __forceinline__ void {body}\(", text), body
        assert "if constexpr (CAP)" in src and "tanhf(" in src and "fmaf(-th, th, 1.f)" in src
    assert "tanh.approx.f32" not in text               # the PTX instruction
    assert re.search(r"void\* pieces, int window, float softcap, int Dv\)", text)
    assert fa.BWD_ARGTYPES[-2] is fa._F and fa.BWD_ARGTYPES[-3] is fa._I
    built = re.findall(r"if constexpr \(D == (\d+)\)\s*if \(p\.causal\) return "
                       r"launch<D, NP, true, true>", text)
    assert tuple(int(d) for d in built) == fa.BWD_SOFTCAP_HEAD_DIMS == (128,)
    for D in fa.HEAD_DIMS:
        q = torch.zeros(1, 4, 2, D)
        kv = torch.zeros(1, 4, 1, D)
        lse = torch.zeros(1, 2, 4)
        for causal in (True, False):
            refused = D not in fa.BWD_SOFTCAP_HEAD_DIMS or not causal
            with pytest.raises(NotImplementedError if refused else ValueError):
                fa.flash_attention_bwd(q, kv, kv, q, lse, q, causal=causal, softcap=50.0)
            with pytest.raises(ValueError):       # no softcap: to the device check
                fa.flash_attention_bwd(q, kv, kv, q, lse, q, causal=causal)


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
    """Each entry of WGMMA_FUNCTIONS names a kernel of its source, the bf16
    SSD body's two product passes and the f32 flash bodies among them, and
    every kernel of csrc/ is a repo kernel to the profiles
    (REPO_KERNELS)."""
    cs = _chip_smoke()
    for name, part in cs.WGMMA_FUNCTIONS:
        text = (_build.CSRC / f"{name}.cu").read_text()
        # a kernel's declaration: no ";" or "{" between __global__ and its name
        assert re.search(rf"__global__ void[^;{{]*\b{part}\w*\(", text), (name, part)
    assert {p for n, p in cs.WGMMA_FUNCTIONS if n.startswith("flash")} == {
        "flash_fwd_wgmma", "dq_wgmma", "dkdv_wgmma",                    # bf16
        "flash_fwd_f32_wgmma", "dq_f32_wgmma", "dkdv_f32_wgmma"}        # f32 on pieces
    assert {p for n, p in cs.WGMMA_FUNCTIONS if n == "ssd_scan"} == {
        "ssd_state_wgmma", "ssd_out_wgmma",                             # bf16
        "ssd_state_f32_wgmma", "ssd_out_f32_wgmma"}                     # f32 on pieces
    assert {p for n, p in cs.WGMMA_FUNCTIONS if n == "paged_attention"} == {"paged_wgmma"}
    assert {p for n, p in cs.WGMMA_FUNCTIONS if n == "ssd_scan_bwd"} == {
        "ssd_bwd_state_wgmma", "ssd_bwd_pair_wgmma"}
    for src in _build.CSRC.glob("*.cu"):
        for fn in _kernel_bodies(src.read_text()):
            assert cs._kernel_class(fn) == "repo kernels", (src.name, fn)


def test_ssd_cases_are_valid_shapes_and_reach_the_bf16_bodys_edges():
    """Every SSD gate case is a shape the wrapper takes, and under its
    shape rule (``wgmma_body``) the bf16 body meets: mamba2-130m's prefill,
    zamba2-2.7b's N 64 at H 80, B 2 with G 2 and S ragged inside a 64-row
    tile, S < 64, S an exact multiple of the chunk, A at scale 50 with N
    128, and each chunk it takes (64, 128, 192, 256); the reduced shapes
    go to the other body."""
    import torch

    from repro_torch.kernels.ssd_scan import wgmma_body

    cases = _chip_smoke().SSD_CASES
    for B, S, H, P, G, N, chunk, scale, tied in cases:
        assert B >= 1 and S >= 1 and H % G == 0 and scale > 0 and tied in (False, True)
        assert P % 16 == 0 and N % 4 == 0 and N <= 128 and chunk % 32 == 0 and chunk <= 256
    new = [c for c in cases if wgmma_body(torch.bfloat16, c[3], c[5], c[6])]
    assert any(c[:7] == (1, 1024, 24, 64, 1, 128, 256) for c in new)
    assert any(c[2] == 80 and c[5] == 64 and c[1] == 1024 for c in new)
    assert any(c[0] == 2 and c[4] == 2 and c[1] % 64 and c[1] > 64 for c in new)
    assert any(c[1] < 64 for c in new)
    assert any(c[1] % c[6] == 0 and c[1] > c[6] for c in new)
    assert any(c[7] == 50.0 and c[5] == 128 for c in new)
    assert {c[6] for c in new} == {64, 128, 192, 256}
    assert any(not wgmma_body(torch.bfloat16, c[3], c[5], c[6]) for c in cases)
    assert not any(wgmma_body(torch.float32, c[3], c[5], c[6]) for c in cases)


def test_paged_cases_are_valid_shapes_and_reach_the_wgmma_bodys_edges():
    """Every paged gate case is a shape the wrapper takes, with tables
    whose allocated pages are distinct and cover each position and a live
    key in every row (a row with none is undefined in the reference); and
    under the shape rule (``wgmma_body``) the bf16 wgmma body meets rep 1
    and 16, D 64 at P 16, D 128 at P 32, every page size it takes,
    positions 63, 64 and 65 (a 64-key stage's edge), position 0, a table
    live to its last column, a window smaller than a page, a window whose
    first key lies inside a split past the first, and a window with a
    softcap."""
    import torch

    from repro_torch.kernels.paged_attention import HEAD_DIMS, REPS, SPLIT_KEYS, wgmma_body

    cs = _chip_smoke()
    new = []
    for case in cs.PAGED_CASES:
        B, H, Hkv, D, P, NP, maxp, window, softcap, (lo, hi) = case
        assert H % Hkv == 0 and H // Hkv in REPS and D in HEAD_DIMS and 0 <= lo <= hi, case
        assert (window is None or window >= 1) and softcap >= 0, case
        tables, pos = cs.paged_tables(torch, case)
        assert tuple(tables.shape) == (B, maxp) and 0 <= int(tables.min()) <= int(tables.max()) < NP
        used = tables[tables != 0]
        assert used.unique().numel() == used.numel(), case
        for b in range(B):
            p = int(pos[b])
            if b < B - 2:
                assert lo <= p <= hi and (tables[b, :min(maxp, p // P + 1)] != 0).all(), case
            first = 0 if window is None else max(0, p - window + 1)
            assert first <= min(p, maxp * P - 1), case
        if wgmma_body(torch.bfloat16, D, P, H // Hkv):
            new.append((case, pos[:B - 2].tolist(), tables[:B - 2]))
        assert not wgmma_body(torch.float32, D, P, H // Hkv)
    assert {c[1] // c[2] for c, _, _ in new} >= {1, 16}
    assert any(c[3] == 64 and c[4] == 16 for c, _, _ in new)
    assert any(c[3] == 128 and c[4] == 32 for c, _, _ in new)
    assert {c[4] for c, _, _ in new} == {8, 16, 32, 64}
    assert any({63, 64, 65} <= set(ps) for _, ps, _ in new)
    assert any(0 in ps for _, ps, _ in new)
    assert any(p // c[4] == c[6] - 1 and (tb[b] != 0).all()
               for c, ps, tb in new for b, p in enumerate(ps))
    assert any(c[7] is not None and c[7] < c[4] for c, _, _ in new)
    assert any(c[7] is not None and any(
        p - c[7] + 1 > SPLIT_KEYS and (p - c[7] + 1) % SPLIT_KEYS for p in ps) for c, ps, _ in new)
    assert any(c[7] is not None and c[8] > 0 for c, _, _ in new)


def test_paged_shape_rule_sends_every_decode_to_the_wgmma_body():
    """starcoder2-3b's decode at the engine's page size goes to the wgmma
    body in bf16, as does every config of the repo whose head dim is 64,
    80 or 128 (the JAX package's registry; 80 is zamba2-2.7b's); f32 goes
    to the other body.  The wgmma body's split (SPLIT_KEYS) is the .cu's, and its
    scratch holds the other body's splits too."""
    import dataclasses

    import torch

    from repro.configs import get_config as jget_config
    from repro.configs import list_archs as jlist_archs
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import (PAGES_PER_SPLIT, SPLIT_KEYS, n_splits,
                                                     wgmma_body)
    from repro_torch.serve.engine import PagedServeEngine

    page = {f.name: f.default for f in dataclasses.fields(PagedServeEngine)}["page"]
    sc = get_config("starcoder2-3b")
    assert (sc.head_dim, sc.n_heads // sc.n_kv_heads, page) == (128, 12, 16)
    assert wgmma_body(torch.bfloat16, sc.head_dim, page, sc.n_heads // sc.n_kv_heads)
    assert not wgmma_body(torch.float32, sc.head_dim, page, sc.n_heads // sc.n_kv_heads)
    cfgs = [jget_config(n) for n in jlist_archs()]
    attn = [c for c in cfgs if c.n_heads and c.head_dim in (64, 80, 128)]
    assert {c.name for c in attn} >= {"starcoder2-3b", "llama3-8b", "qwen2-72b", "gemma2-27b",
                                      "zamba2-2.7b"}
    for c in attn:
        assert wgmma_body(torch.bfloat16, c.head_dim, page, c.n_heads // c.n_kv_heads), c.name
    assert not wgmma_body(torch.float32, 80, page, 1)
    src = (_build.CSRC / "paged_attention.cu").read_text()
    assert re.search(rf"constexpr int SPLIT_KEYS = {SPLIT_KEYS};", src)
    for P in (8, 16, 32, 64):
        for maxp in (1, 7, 64, 128):
            assert n_splits(maxp, P, True) >= -(-maxp // PAGES_PER_SPLIT)


def test_ssd_shape_rule_serves_every_ssm_config_on_the_bf16_body():
    """No SSM config of the repo (the JAX package's registry: mamba2-130m,
    zamba2-2.7b) goes to the other bf16 body, nor the port's mamba2-130m;
    the reduced configs' shapes do."""
    import torch

    from repro.configs import get_config as jget_config
    from repro.configs import list_archs as jlist_archs
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.ssd_scan import wgmma_body

    ssm = [jget_config(n) for n in jlist_archs() if jget_config(n).ssm is not None]
    assert {c.name for c in ssm} >= {"mamba2-130m", "zamba2-2.7b"}
    for cfg in [*ssm, get_config("mamba2-130m")]:
        s = cfg.ssm
        assert wgmma_body(torch.bfloat16, s.head_dim, s.d_state, s.chunk), cfg.name
    r = reduced(get_config("mamba2-130m")).ssm
    assert not wgmma_body(torch.bfloat16, r.head_dim, r.d_state, r.chunk)


def test_ssd_bwd_shape_rule_serves_every_ssm_config_on_the_wgmma_body():
    """Every SSM config of the repo (the JAX package's registry and the
    port's mamba2-130m) takes the backward's wgmma body in both dtypes,
    and the reduced config's shapes the CUDA-core body; the rule is the C
    source's ``wgmma_shape``, and the scratch the wrapper sizes is what the
    C entry lays out (the wgmma body's rows from a multiple of 4 floats,
    f32 inputs' pieces after them)."""
    import torch

    from repro.configs import get_config as jget_config
    from repro.configs import list_archs as jlist_archs
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.ssd_scan import bwd_wgmma_body, bwd_work_floats

    ssm = [jget_config(n) for n in jlist_archs() if jget_config(n).ssm is not None]
    for cfg in [*ssm, get_config("mamba2-130m")]:
        s = cfg.ssm
        assert bwd_wgmma_body(s.head_dim, s.d_state, s.chunk), cfg.name
    r = reduced(get_config("mamba2-130m")).ssm
    assert not bwd_wgmma_body(r.head_dim, r.d_state, r.chunk)
    src = (_build.CSRC / "ssd_scan_bwd.cu").read_text()
    assert "return P == WP && (N == 64 || N == 128) && L % TR == 0 && L >= TR && L <= 256;" in src
    for P, N, L in ((64, 64, 64), (64, 128, 256), (64, 128, 192), (64, 96, 64), (32, 64, 64),
                    (64, 64, 32), (64, 64, 320)):
        assert bwd_wgmma_body(P, N, L) == (P == 64 and N in (64, 128) and L % 64 == 0
                                           and 64 <= L <= 256)
    Bb, S, H, P, G, N, L = 3, 700, 6, 64, 2, 128, 256
    nc = -(-S // L)
    base = 2 * Bb * nc * H * N * P + 2 * Bb * S * H * N + 2 * Bb * nc * H
    tail = -(-base // 4) * 4 + 4 * Bb * nc * H * L
    assert bwd_work_floats(Bb, S, H, P, G, N, L, torch.bfloat16) == tail
    assert bwd_work_floats(Bb, S, H, P, G, N, L, torch.float32) == \
        tail + 3 * (Bb * S * H * P + Bb * S * G * N)
    assert bwd_work_floats(Bb, S, H, 32, G, N, L, torch.float32) == \
        2 * Bb * nc * H * N * 32 + 2 * Bb * S * H * N + 2 * Bb * nc * H


def test_ssd_limits_add_the_bf16_bodys_terms_only_where_it_runs():
    import torch

    cs = _chip_smoke()
    dt, A = torch.full((1, 300, 2), 0.5), torch.tensor([-1.0, -0.1])
    for dtype, P, N, chunk, new in ((torch.bfloat16, 64, 128, 256, True),
                                    (torch.bfloat16, 16, 16, 32, False),
                                    (torch.float32, 64, 128, 256, False)):
        x = torch.zeros(1, 300, 2, P, dtype=dtype)
        u_out, rel_y, rel_st = cs.ssd_limits(torch, x, dt, A, N, chunk)
        acs_max = 0.5 * min(chunk, 300)       # the largest |cumsum(dt A)| of a chunk
        rel = cs.SSD_REL + 8 * cs.F32_EPS * acs_max
        assert u_out == (cs.BF16_U if dtype == torch.bfloat16 else 0.0)
        assert rel_y == pytest.approx(rel + new * (cs.SSD_U_OPERAND + cs.SSD_U_SPLIT))
        assert rel_st == pytest.approx(rel + new * cs.SSD_U_SPLIT)


def test_ssd_f32_body_serves_every_ssm_config_under_the_f32_gate():
    """In f32 every SSM config of the repo (the JAX package's registry and
    the port's mamba2-130m) takes the f32 body of three passes on three
    bf16 pieces, the reduced config's shapes the one-pass body; the rule
    is the bf16 body's shapes (the C source's one ``wgmma_shape``) in
    f32.  The gate reads every f32 call with no bf16 term, the sharp case
    (mamba2-130m's prefill, A at scale 0.01, C tied to B) among them; the
    C entries take the wrapper's arguments."""
    import torch

    from repro.configs import get_config as jget_config
    from repro.configs import list_archs as jlist_archs
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.ssd_scan import (ARGTYPES, PASSES_ARGTYPES, f32_wgmma_body,
                                              wgmma_body)

    ssm = [jget_config(n) for n in jlist_archs() if jget_config(n).ssm is not None]
    for cfg in [*ssm, get_config("mamba2-130m")]:
        s = cfg.ssm
        assert f32_wgmma_body(torch.float32, s.head_dim, s.d_state, s.chunk), cfg.name
        assert not f32_wgmma_body(torch.bfloat16, s.head_dim, s.d_state, s.chunk)
    r = reduced(get_config("mamba2-130m")).ssm
    assert not f32_wgmma_body(torch.float32, r.head_dim, r.d_state, r.chunk)
    for P, N, L in ((64, 64, 64), (64, 128, 256), (64, 128, 192), (64, 96, 64), (32, 64, 64),
                    (64, 64, 32), (64, 64, 320)):
        assert f32_wgmma_body(torch.float32, P, N, L) == wgmma_body(torch.bfloat16, P, N, L) \
            == (P == 64 and N in (64, 128) and L % 64 == 0 and 64 <= L <= 256)
    cs = _chip_smoke()
    sharp = [c for c in cs.SSD_CASES if c[8]]
    assert [c[:8] for c in sharp] == [(1, 1024, 24, 64, 1, 128, 256, 0.01)]
    for B, S, H, P, G, N, chunk, scale, _ in cs.SSD_CASES:
        x = torch.zeros(B, S, H, P)
        dt, A = torch.full((B, S, H), 0.8), torch.full((H,), -scale)
        u_out, rel_y, rel_st = cs.ssd_limits(torch, x, dt, A, N, chunk)
        acs_max = 0.8 * scale * min(S, chunk)
        assert u_out == 0.0 and rel_y == rel_st
        assert rel_y == pytest.approx(cs.SSD_REL + 8 * cs.F32_EPS * acs_max)
    text = (_build.CSRC / "ssd_scan.cu").read_text()
    assert text.count("return P == WP && (N == 64 || N == 128) && L % TR == 0 && L >= TR && "
                      "L <= 256;") == 1
    for name, argtypes in (("ssd_scan_fwd", ARGTYPES), ("ssd_scan_passes", PASSES_ARGTYPES)):
        sig = re.search(rf'extern "C" int {name}\(([^)]*)\)', text).group(1)
        params = [a.strip() for a in sig.split(",")]
        assert len(params) == len(argtypes), name
        assert all("*" in a for a in params[:7]) and params[-1] == "void* stream"
        assert all(a.startswith("int ") for a in params[7:-1])


def test_ssd_forward_scratch_is_the_c_entrys_layout():
    """``work_floats``: the bf16 body's chunk states in f32 and bf16 and
    the decays (as before the f32 body); the f32 body's chunk states, their
    three bf16 pieces, the decays up to a multiple of 4 floats, then the
    three bf16 pieces of x, B and C; 302 MB at mamba2-130m's train shape;
    none for the one-pass body."""
    import torch

    from repro_torch.kernels.ssd_scan import work_floats

    Bb, S, H, P, G, N, L = 3, 700, 6, 64, 2, 128, 256
    nc = -(-S // L)
    n_states, n_dec = Bb * nc * H * N * P, Bb * nc * H
    assert work_floats(Bb, S, H, P, G, N, L, torch.bfloat16) == Bb * nc * H * (N * P * 3 // 2 + 1)
    assert work_floats(Bb, S, H, P, G, N, L, torch.float32) == \
        n_states + 3 * n_states // 2 + -(-n_dec // 4) * 4 + 3 * (Bb * S * H * P + 2 * Bb * S * G * N) // 2
    assert n_dec % 4 and work_floats(Bb, S, H, P, G, N, L, torch.float32) % 4 == 0
    assert work_floats(Bb, S, H, 32, G, N, L, torch.float32) == 0
    assert work_floats(Bb, S, H, 16, G, 16, 32, torch.bfloat16) == 0
    mb = work_floats(16, 1024, 24, 64, 1, 128, 256, torch.float32) * 4 / 1e6
    assert mb == pytest.approx(302.0, abs=0.05)


def test_ssd_f32_bounds_at_the_train_shape():
    """The f32 forward at mamba2-130m's train shape (MAMBA2_TRAIN): 19.9
    GFLOP and 232 MB; bound by operations at 989/6 TFLOP/s in 0.121 ms,
    at the CUDA cores' 67 TFLOP/s in 0.297 ms, by bytes in 0.069 ms."""
    cs = _chip_smoke()
    flops, nbytes = cs.ssd_work(*cs.MAMBA2_TRAIN, 4)
    assert flops == pytest.approx(19.89e9, rel=1e-3) and nbytes == pytest.approx(232.2e6, rel=1e-3)
    ms, by = cs._bound(flops, nbytes, cs.PEAK_F32_SPLIT_FLOPS)
    assert by == "operations" and ms == pytest.approx(0.1207, rel=1e-3)
    assert cs._bound(flops, nbytes, cs.PEAK_F32_FLOPS)[0] == pytest.approx(0.2969, rel=1e-3)
    assert nbytes / cs.PEAK_BYTES * 1e3 == pytest.approx(0.0693, rel=1e-2)


@pytest.mark.parametrize("B,S,H,P,G,N,L", [
    (1, 10, 2, 3, 1, 2, 4), (2, 9, 4, 2, 2, 3, 3), (1, 12, 6, 2, 3, 2, 4), (1, 5, 2, 2, 2, 2, 8)])
def test_ssd_work_counts_the_causal_products_once(B, S, H, P, G, N, L):
    """ssd_work's flops against a brute-force count: per (batch, head,
    chunk) C . state over every row, the masked product with x and B^T x;
    C B^T per (batch, group, chunk) over the causal pairs; 2 flops a
    multiply-add.  Bytes: x, B, C, y once, dt, A and the state in f32."""
    macs = 0
    for _ in range(B):
        for c0 in range(0, S, L):
            rows = range(c0, min(S, c0 + L))
            pairs = [(l, s) for l in rows for s in rows if s <= l]
            macs += G * len(pairs) * N                        # C B^T, per group
            macs += H * (len(rows) * N * P                    # C . state
                         + len(pairs) * P                     # (masked C B^T) x
                         + len(rows) * N * P)                 # B^T diag(w) x
    flops, nbytes = _chip_smoke().ssd_work(B, S, H, P, G, N, L, 2)
    assert flops == 2 * macs
    assert nbytes == 2 * (2 * B * S * H * P + 2 * B * S * G * N) + 4 * (B * S * H + H + B * H * N * P)


def test_f32_flash_bounds_at_the_cli_shape():
    """The f32 flash bodies' bounds at the train CLI's attention
    (BERT_ATTN, f32): six bf16 passes a product, so 989/6 TFLOP/s: the
    forward's 25.8 GFLOP in 0.156 ms and the backward's five products in
    0.391 ms, both bound by operations; at the CUDA cores' 67 TFLOP/s
    (bound_simt_ms) 0.385 and 0.962 ms.  bf16 keeps the bf16 peak."""
    import torch

    cs = _chip_smoke()
    B, S, H, Hkv, D, causal = cs.BERT_ATTN
    q = torch.empty(B, S, H, D, device="meta")
    k = torch.empty(B, S, Hkv, D, device="meta")
    assert cs.PEAK_F32_SPLIT_FLOPS == cs.PEAK_BF16_FLOPS / 6
    ms, by = cs.flash_bound(q, k, causal, True)
    assert by == "operations" and ms == pytest.approx(0.1563, rel=1e-3)
    ms, by = cs.flash_bwd_bound(q, k, causal)
    assert by == "operations" and ms == pytest.approx(0.3909, rel=1e-3)
    assert cs.flash_bound(q, k, causal, True, cs.PEAK_F32_FLOPS)[0] == pytest.approx(0.3846, rel=1e-3)
    assert cs.flash_bwd_bound(q, k, causal, cs.PEAK_F32_FLOPS)[0] == pytest.approx(0.9616, rel=1e-3)
    qb, kb = q.to(torch.bfloat16), k.to(torch.bfloat16)
    assert cs.flash_bwd_bound(qb, kb, causal)[0] == pytest.approx(0.06514, rel=1e-3)


def test_ssd_work_at_the_serve_shape():
    """mamba2-130m's 1024-token prefill: 1.24 GFLOP (f32 bound 0.0186 ms
    at 67 TFLOP/s), bound by bytes in bf16 (0.0023 ms at 3.35 TB/s)."""
    cs = _chip_smoke()
    flops, nbytes = cs.ssd_work(1, 1024, 24, 64, 1, 128, 256, 2)
    assert flops == pytest.approx(1.2432e9, rel=1e-4)
    assert cs._bound(flops, nbytes, cs.PEAK_F32_FLOPS)[0] == pytest.approx(0.01856, rel=1e-3)
    ms, by = cs._bound(flops, nbytes, cs.PEAK_BF16_FLOPS)
    assert by == "bytes" and ms == pytest.approx(0.00230, rel=1e-2)


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


def test_ssd_bwd_source_is_built_for_sm_90a_with_its_c_entry(tmp_path, monkeypatch):
    """The SSD backward's source is one of the sources the build compiles,
    for sm_90a; its C entry takes the wrapper's arguments (13 pointers, 8
    ints, the stream); its kernels (the CUDA-core body's five, the wgmma
    body's state, pair and tail passes beside the carry, head sums and dA
    they share) sum in a fixed order (no atomics) and each planted fault
    of the backward lies in a pass of its own (the reverse carry, the head
    sums, the wgmma body's pair pass)."""
    from repro_torch.kernels.ssd_scan import BWD_ARGTYPES

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", _FakeNvcc)
    monkeypatch.setattr(_FakeNvcc, "commands", [])
    _build.build_all()
    (cmd,) = [c for c in _FakeNvcc.commands if Path(c[-1]).name == "ssd_scan_bwd.cu"]
    assert "arch=compute_90a,code=sm_90a" in cmd
    text = (_build.CSRC / "ssd_scan_bwd.cu").read_text()
    sig = re.search(r'extern "C" int ssd_scan_bwd\(([^)]*)\)', text).group(1)
    params = [a.strip() for a in sig.split(",")]
    assert len(params) == len(BWD_ARGTYPES) == 22
    assert all("*" in a for a in params[:13]) and params[-1] == "void* stream"
    assert all(a.startswith("int ") for a in params[13:21])
    assert not re.search(r"\batomic\w*\(", text)
    bodies = _kernel_bodies(text)
    assert sorted(bodies) == ["ssd_bwd_carry_kernel", "ssd_bwd_dA_kernel", "ssd_bwd_grad_kernel",
                              "ssd_bwd_heads_kernel", "ssd_bwd_pair_wgmma_kernel",
                              "ssd_bwd_state_kernel", "ssd_bwd_state_wgmma_kernel",
                              "ssd_bwd_tail_kernel"]
    faults = [f[3] for f in _chip_smoke().FAULTS if f[0] == "ssd_scan_bwd"]
    assert [sum(old in bodies[k] for old in faults) for k in
            ("ssd_bwd_carry_kernel", "ssd_bwd_heads_kernel", "ssd_bwd_pair_wgmma_kernel")] \
        == [1, 1, 1]


@pytest.mark.parametrize("B,S,H,P,G,N,L", [
    (1, 10, 2, 3, 1, 2, 4), (2, 9, 4, 2, 2, 3, 3), (1, 12, 6, 2, 3, 2, 4), (1, 5, 2, 2, 2, 2, 8)])
def test_ssd_bwd_work_counts_the_products_once(B, S, H, P, G, N, L):
    """ssd_bwd_work's flops against a brute-force count: per (batch, head,
    chunk) the five products over (rows, N, P) and, over the causal
    pairs, gy x^T and M^T gy (P each); C B^T and the sums for dB and dC
    (N each) per (batch, group, chunk); 2 flops a multiply-add.
    Bytes: x, gy, dx, B, C, dB, dC once at 2 bytes, dt, ddt, A, dA and
    gstate in f32."""
    macs = 0
    for _ in range(B):
        for c0 in range(0, S, L):
            rows = range(c0, min(S, c0 + L))
            pairs = [(l, s) for l in rows for s in rows if s <= l]
            macs += G * len(pairs) * 3 * N
            macs += H * (5 * len(rows) * N * P + len(pairs) * 2 * P)
    flops, nbytes = _chip_smoke().ssd_bwd_work(B, S, H, P, G, N, L, 2)
    assert flops == 2 * macs
    assert nbytes == 2 * (3 * B * S * H * P + 4 * B * S * G * N) \
        + 4 * (2 * B * S * H + 2 * H + B * H * N * P)


def test_ssd_bwd_cases_and_bound_at_the_train_shape():
    """The backward's gate meets mamba2-130m's train shape, a ragged S, G 2
    at H 8, S shorter than the chunk and a non-zero gstate, each a shape
    the wrapper takes, and under the wgmma body's rule (``bwd_wgmma_body``)
    each chunk it takes (64, 128, 192, 256), G 1 to 4, zamba2-2.7b's N 64
    at H 80, S ragged inside a 64-row tile and S < 64, with the reduced
    shapes on the CUDA-core body; at the train shape it needs 46.8 GFLOP
    (0.698 ms at the f32 CUDA-core peak, 0.284 ms on three pieces at a
    sixth of the bf16 peak, 0.0473 ms at the bf16 one) and moves 183.5 MB
    in bf16 (0.0548 ms), so in bf16 its bound is the bytes'."""
    from repro_torch.kernels.ssd_scan import BWD_HEAD_DIMS, bwd_wgmma_body

    cs = _chip_smoke()
    cases = cs.SSD_BWD_CASES
    for B, S, H, P, G, N, chunk, nonzero in cases:
        assert P in BWD_HEAD_DIMS and N % 4 == 0 and N <= 128 and H % G == 0
        assert chunk % 32 == 0 and chunk <= 256 and isinstance(nonzero, bool)
    assert cases[0][:7] == cs.MAMBA2_TRAIN == (16, 1024, 24, 64, 1, 128, 256)
    assert any(c[1] % c[6] and c[1] > c[6] for c in cases)
    assert any(c[4] == 2 and c[2] == 8 for c in cases)
    assert any(c[1] < c[6] for c in cases)
    assert any(c[7] for c in cases) and not cases[0][7]
    flops, nbytes = cs.ssd_bwd_work(*cs.MAMBA2_TRAIN, 2)
    assert flops == pytest.approx(46.764e9, rel=1e-4) and nbytes == pytest.approx(183.5e6, rel=1e-3)
    assert cs._bound(flops, nbytes, cs.PEAK_F32_FLOPS)[0] == pytest.approx(0.698, rel=1e-3)
    assert cs._bound(flops, nbytes, cs.PEAK_F32_SPLIT_FLOPS)[0] == pytest.approx(0.2837, rel=1e-3)
    ms, by = cs._bound(flops, nbytes, cs.PEAK_BF16_FLOPS)
    assert by == "bytes" and ms == pytest.approx(0.05478, rel=1e-3)
    body = [c for c in cases if bwd_wgmma_body(c[3], c[5], c[6])]
    assert {c[6] for c in body} == {64, 128, 192, 256}
    assert {c[4] for c in body} >= {1, 2, 3, 4}
    assert any(c[2] == 80 and c[5] == 64 for c in body)
    assert any(c[1] % 64 and c[1] > 64 for c in body) and any(c[1] < 64 for c in body)
    assert any(not bwd_wgmma_body(c[3], c[5], c[6]) for c in cases)


def test_ssm_launches_per_step_at_the_train_shape():
    """mamba2-130m at B 16 x S 1024: 24 layers, so 48 scans (remat) and 24
    backwards a microbatch, and no flash launch; loss chunks of 159
    positions (7) at 16 rows, of 318 (4) at the 8 rows of microbatch 2."""
    from repro_torch.configs import get_config

    cfg = get_config("mamba2-130m")
    cs = _chip_smoke()
    assert cs.train_launches_per_step(cfg, 16, 1024) == {
        "ssd_scan": 48, "ssd_scan_bwd": 24, "fused_xent": 14, "fused_xent_bwd": 7}
    assert cs.train_launches_per_step(cfg, 16, 1024, 2) == {
        "ssd_scan": 96, "ssd_scan_bwd": 48, "fused_xent": 16, "fused_xent_bwd": 8}


@pytest.mark.parametrize("S,causal,window", [
    (9, True, None), (9, False, None), (37, True, 5), (37, True, 1), (64, True, 64),
    (37, True, 100)])
def test_hidden_mask_is_the_rule_the_bounds_count(S, causal, window):
    """One masking rule: the gate's reference and the SDPA yardstick hide
    what ``hidden_mask`` hides, and the bounds count what it leaves."""
    import torch

    cs = _chip_smoke()
    hide = cs.hidden_mask(torch, S, causal, window, "cpu")
    i = torch.arange(S)
    want = torch.zeros(S, S, dtype=torch.bool)
    for q in range(S):
        for k in range(S):
            want[q, k] = (causal and k > q) or (window is not None and k <= q - window)
    assert torch.equal(hide, want)
    assert cs.attn_pairs(S, causal, window) == float((~hide).sum())
    if window is not None:
        assert torch.equal(cs.window_mask(torch, S, window, "cpu"), ~hide)
    assert not hide[i, i].any()                    # a query always sees its own key


def test_stack_frame_faults_names_the_wgmma_bodies_with_a_frame():
    cs = _chip_smoke()
    report = {"warnings": [],
              "_Z15dkdv_wgmma_kernelILi256ELb1EEvv": [
                  "256 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
                  "ptxas info    : Used 176 registers"],
              "_Z13dq_wgmma_kernelILi64ELb0EEvv": [
                  "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"],
              "_Z15dq_simt_kernelILi256EEv6Params": [
                  "64 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"]}
    assert cs.stack_frame_faults(report) == [
        "_Z15dkdv_wgmma_kernelILi256ELb1EEvv: 256 bytes stack frame, 0 bytes spill stores, "
        "0 bytes spill loads"]
    assert cs.FRAMELESS_SOURCES == ("flash_attention_bwd", "ssd_scan_bwd", "ssd_scan")


def _zeroing_loops(text):
    """[(array, its declared size, the loop's bound)] of every loop of the
    form ``for (int x = 0; x < N; ++x) a[x] = b[x] = 0`` in a kernel
    source, each array taken at its latest declaration above the loop (a
    local array, or a reference parameter such as ``float (&s)[N / 2]``)."""
    decl = re.compile(r"\b(?:float|double|uint32_t)\s+([^;(]*\[[^;]*);")
    param = re.compile(r"\b(?:float|double|uint32_t)\s+\(&(\w+)\)\[([^\]]+)\]")
    loop = re.compile(r"for \(int (\w+) = 0; \1 < ([^;]+); \+\+\1\) ((?:\w+\[\1\] = )+)0")
    sizes, out = {}, []
    for line in text.splitlines():
        for m in param.finditer(line):
            sizes[m.group(1)] = m.group(2)
        for m in decl.finditer(line):
            for a in re.finditer(r"(\w+)\[([^\]]+)\]", m.group(1)):
                sizes[a.group(1)] = a.group(2)
        for m in loop.finditer(line):
            for a in re.findall(r"(\w+)\[", m.group(3)):
                out.append((a, sizes.get(a), m.group(2).strip()))
    return out


@pytest.mark.parametrize("source", sorted(p.name for p in _build.CSRC.glob("*.cu")))
def test_zeroing_loops_stay_inside_their_arrays(source):
    """A register array zeroed by a loop is zeroed to its declared size, no
    further (the flash backward's dK and dV at head dim 256 hold half the
    head dim's columns, DH / 2 floats, not D / 2)."""
    loops = _zeroing_loops((_build.CSRC / source).read_text())
    assert all(size is not None and size == bound for _, size, bound in loops), loops
    if source == "flash_attention_bwd.cu":
        assert ("dk", "DH / 2", "DH / 2") in loops and ("dv", "DH / 2", "DH / 2") in loops


def test_zeroing_loop_check_sees_a_loop_past_its_array():
    text = "  float s[QT / 2], dk[DH / 2], dv[DH / 2];\n" \
           "  for (int x = 0; x < D / 2; ++x) dk[x] = dv[x] = 0.f;\n"
    assert _zeroing_loops(text) == [("dk", "DH / 2", "D / 2"), ("dv", "DH / 2", "D / 2")]
    text = "void f(float (&s)[N / 2], float (&d)[N]) {\n" \
           "  for (int x = 0; x < N; ++x) s[x] = d[x] = 0.f;\n"
    assert _zeroing_loops(text) == [("s", "N / 2", "N"), ("d", "N", "N")]


def test_mla_head_dims_in_the_flash_sources_and_wrapper():
    """MLA's q/k head dim 192 is laid out as 256 (``box_cols<192>()``),
    its v at 128 (``v_dim``); both C entries take v's head dim ``Dv`` last,
    after the arguments an earlier build takes, as the wrappers' argtypes
    do; D 192 is dispatched with Dv 128 alone, causal and without a
    softcap in the backward; the wrapper refuses every (D, Dv) pair but D
    == Dv in HEAD_DIMS and (192, 128) before it looks at the device."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    hopper = (_build.CSRC / "hopper.cuh").read_text()
    box = hopper[hopper.index("constexpr int box_cols()"):]
    box = box[:box.index("\n}\n")]
    assert "D == 192 ? 256" in box                     # box_cols<192>() == 256
    assert re.search(r"constexpr int v_dim\(\) \{\s*return D == 192 \? 128 : D;", hopper)
    assert "split3_kernel<192>" in hopper
    fwd = (_build.CSRC / "flash_attention.cu").read_text()
    bwd = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    assert re.search(r"void\* stream, void\* pieces, int Dv\) \{", fwd)
    assert re.search(r"void\* pieces, int window, float softcap, int Dv\) \{", bwd)
    for text in (fwd, bwd):
        assert re.search(r"if \(D == 192 && Dv == 128\) return", text)
        assert "if (Dv != D) return static_cast<int>(cudaErrorInvalidValue);" in text
    assert re.search(r"struct Tiles<192, NP> : Tiles<256, NP>", fwd)
    assert re.search(r"struct Shape<192, NP> : Shape<256, NP>", bwd)
    assert re.search(r"if constexpr \(D == 192\) \{\s*if \(p\.softcap > 0\.f \|\| !p\.causal\) "
                     r"return cudaErrorInvalidValue;", bwd)
    assert len(fa.FWD_ARGTYPES) == 30 and fa.FWD_ARGTYPES[-1] is fa._I
    assert fa.FWD_ARGTYPES[-3:-1] == [fa._P, fa._P]           # the stream, the pieces
    assert len(fa.BWD_ARGTYPES) == 38 and fa.BWD_ARGTYPES[-1] is fa._I
    assert fa.BWD_ARGTYPES[-3:-1] == [fa._I, fa._F]           # the window, the softcap
    pairs = [(D, Dv) for D in (48, 64, 80, 96, 128, 192, 256) for Dv in (32, 64, 80, 128, 192, 256)]
    taken = [p for p in pairs if (p[0] == p[1] and p[0] in fa.HEAD_DIMS) or p == (192, 128)]
    assert sorted(taken) == sorted([(D, D) for D in fa.HEAD_DIMS] + [(192, 128)])
    for D, Dv in pairs:
        q, v = torch.zeros(1, 4, 2, D), torch.zeros(1, 4, 2, Dv)
        want = "not on a CUDA device" if (D, Dv) in taken else "head dims"
        with pytest.raises(ValueError, match=want):
            fa.flash_attention_fwd(q, q, v)
        with pytest.raises(ValueError, match=want):
            fa.flash_attention_bwd(q, q, v, torch.zeros(1, 4, 2, Dv), torch.zeros(1, 2, 4),
                                   torch.zeros(1, 4, 2, Dv))

"""The port's paged serving against the JAX package: page allocation and
admission decisions, greedy tokens of the continuous-batching engine
(JAX side with both Pallas kernels in interpret mode), and the launcher
run as a user runs it; plus import hygiene and the device rule of the
entry points."""
import ast
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import LayerSpec as JLayerSpec
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import uniform_schedule as juniform
from repro.models import build_model as jbuild_model
from repro.serve import FifoScheduler as JFifoScheduler
from repro.serve import PageAllocator as JPageAllocator
from repro.serve import PagedServeEngine as JPagedServeEngine
from repro.serve import Request as JRequest
from repro_torch.configs import default_run_config, get_config, reduced
from repro_torch.configs.base import LayerSpec, ShapeConfig, uniform_schedule
from repro_torch.models.model import build_model
from repro_torch.serve.engine import PagedServeEngine
from repro_torch.serve.paged_cache import PageAllocator
from repro_torch.serve.scheduler import FifoScheduler, Request

# the suite runs test files in parallel workers: keep torch's CPU threads few
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
LENS = (70, 13, 100)        # two prompts reach the JAX flash kernel at bucket 128
MAX_NEW = 5
ENGINE_KW = dict(page=8, n_pages=64, max_slots=4)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


# ---------------------------------------------------------------------------
# allocator and scheduler: the same decisions as the JAX package
# ---------------------------------------------------------------------------


def test_allocator_matches_jax():
    ja, ta = JPageAllocator(17), PageAllocator(17)
    rng = np.random.RandomState(0)
    live = []
    for _ in range(60):
        if live and (rng.rand() < 0.4 or not ta.can_alloc(3)):
            pages = live.pop(rng.randint(len(live)))
            ja.free(pages)
            ta.free(pages)
        else:
            n = int(rng.randint(1, 4))
            assert ja.can_alloc(n) == ta.can_alloc(n)
            got, want = ta.alloc(n), ja.alloc(n)
            assert got == want and 0 not in got
            live.append(got)
        assert (ta.n_free, ta.utilization()) == (ja.n_free, ja.utilization())
    with pytest.raises(MemoryError):
        ta.alloc(ta.n_free + 1)


class _FakeKV:
    def __init__(self, free):
        self.free = free

    def can_admit(self, total_len):
        return total_len <= self.free


def test_scheduler_matches_jax():
    js, ts = JFifoScheduler(max_tokens=100), FifoScheduler(max_tokens=100)
    rng = np.random.RandomState(1)
    admitted = {"jax": [], "torch": []}
    for rid in range(40):
        n, m = int(rng.randint(1, 40)), int(rng.randint(1, 30))
        js.submit(JRequest(rid=rid, tokens=[1] * n, max_new=m))
        ts.submit(Request(rid=rid, tokens=[1] * n, max_new=m))
        kv = _FakeKV(free=int(rng.randint(20, 80)))
        for name, s in (("jax", js), ("torch", ts)):
            r = s.try_admit(kv)
            if r is not None:
                admitted[name].append(r)
        if admitted["jax"] and rid % 3 == 0:
            js.release(admitted["jax"].pop(0))
            ts.release(admitted["torch"].pop(0))
        assert [r.rid for r in admitted["jax"]] == [r.rid for r in admitted["torch"]]
        assert (js.live_tokens, js.rejects, len(js)) == \
            (ts.live_tokens, ts.rejects, len(ts))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    """Reduced starcoder2-3b, 2 stacked layers, one JAX-initialised set of
    weights; the JAX engine's greedy tokens with its Pallas flash
    (prefill) and paged (decode) kernels in interpret mode."""
    jcfg = dataclasses.replace(jreduced(jget_config("starcoder2-3b")),
                               schedule=juniform(2, JLayerSpec()))
    tcfg = dataclasses.replace(reduced(get_config("starcoder2-3b")),
                               schedule=uniform_schedule(2, LayerSpec()))
    jmodel = jbuild_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    prompts = [np.random.RandomState(i + 1).randint(4, jcfg.vocab_size, n).tolist()
               for i, n in enumerate(LENS)]
    run = JRunConfig(model=jcfg, shape=JShapeConfig("s", 16, 2, "decode"),
                     sharding="ddp", param_dtype="float32",
                     activation_dtype="float32", use_pallas=True)
    jeng = JPagedServeEngine(model=jmodel, run=run, use_pallas_decode=True,
                             **ENGINE_KW)
    rids = [jeng.submit(p, MAX_NEW) for p in prompts]
    got = jeng.serve(params)
    want = [got[r] for r in rids]
    tmodel = build_model(tcfg, device="cpu")
    tmodel.load_jax_params(jax.tree_util.tree_map(np.array, params))
    return tmodel, prompts, want


def _engine(tmodel, **kw):
    run = default_run_config(tmodel.cfg, ShapeConfig("s", 16, 2, "decode"))
    return PagedServeEngine(tmodel, run, **{**ENGINE_KW, **kw})


def test_engine_matches_jax_greedy(served):
    tmodel, prompts, want = served
    eng = _engine(tmodel)
    rids = [eng.submit(p, MAX_NEW) for p in prompts]
    got = eng.serve()
    assert [got[r] for r in rids] == want
    assert eng.utilization() == 0.0          # every page came back
    assert eng.kv.allocator.n_free == ENGINE_KW["n_pages"] - 1
    # a second wave on the same pools gives the same tokens
    rids = [eng.submit(p, MAX_NEW) for p in prompts]
    got = eng.serve()
    assert [got[r] for r in rids] == want
    assert eng.metrics["serve_requests_finished"].value == 2 * len(prompts)
    assert len(eng.samples["ttft_ms"]) == 2 * len(prompts)


def test_engine_staggered_arrivals(served):
    """Requests joining mid-flight get the tokens they get alone."""
    tmodel, prompts, want = served
    eng = _engine(tmodel)
    finished = {}
    rids = [eng.submit(prompts[0], MAX_NEW)]
    for step in range(60):
        if step in (2, 4):
            rids.append(eng.submit(prompts[len(rids)], MAX_NEW))
        for req in eng.step():
            finished[req.rid] = req.out
        if len(finished) == len(prompts):
            break
    assert [finished[r] for r in rids] == want
    assert eng.utilization() == 0.0


def test_engine_queues_past_capacity(served):
    """More requests than slots: the queue drains as slots free up."""
    tmodel, prompts, want = served
    eng = _engine(tmodel, max_slots=1)
    rids = [eng.submit(p, MAX_NEW) for p in prompts]
    got = eng.serve()
    assert [got[r] for r in rids] == want
    assert eng.utilization() == 0.0


def test_engine_rejects_oversized_request(served):
    tmodel, prompts, _ = served
    eng = _engine(tmodel, max_pages=4)
    with pytest.raises(ValueError, match="per-sequence capacity"):
        eng.submit(prompts[2], MAX_NEW)


def test_launcher_cpu_subprocess():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--reduced", "--paged", "--batch", "3", "--prompt-len", "11",
         "--max-new", "4"],
        capture_output=True, text=True, env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "3 requests x 11 prompt + 4 new" in out.stdout
    assert "on cpu" in out.stdout


# ---------------------------------------------------------------------------
# hygiene and the device rule
# ---------------------------------------------------------------------------


def _port_modules():
    return sorted("repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
                  .replace(".__init__", "") for p in PORT.rglob("*.py"))


def test_port_imports_no_jax_and_no_reference_package():
    """Every port module, imported in a fresh process, pulls in neither
    jax nor any module of the JAX package ``repro``; and no import
    statement anywhere in the port or ``chip_smoke.py`` (lazy ones inside
    functions included) names them."""
    mods = _port_modules()
    assert "repro_torch.serve.engine" in mods and len(mods) >= 20
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "sys.path.insert(0, sys.argv[1]); import chip_smoke\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr
    for path in list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) else []
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), (path, n)


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("starcoder2-3b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    env = {**_env(), "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--reduced", "--paged"],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr


def test_chip_smoke_fails_without_card_or_checkout(tmp_path):
    """Without a card, and alone in a directory, the chip smoke test
    exits non-zero and prints no result line."""
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            shutil.copy(ROOT / "chip_smoke.py", script)
        env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                             text=True, env=env, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout

"""The port's data layer against the JAX package's on the CPU: the same
corpus, tokenizer and packed shards from ``DataPipeline.build``, the
same batches at every step across an epoch boundary (per host of a
2-host layout, at 1 and 3 loader workers), the same serialisable
position and the same refusals on restore; and the device prefetch's
order, content and end of stream."""
import filecmp

import numpy as np
import pytest
import torch

from repro.data import DataPipeline as JDataPipeline
from repro_torch.data import DataPipeline, DevicePrefetch, PipelineState
from repro_torch.data.device_prefetch import on_device

BATCH, SEQ, N_FUNCTIONS, SEED = 8, 64, 250, 5
BUILD = dict(n_functions=N_FUNCTIONS, seq_len=SEQ, batch_size=BATCH, max_merges=60,
             network=None)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """One tiny corpus built by each package, in its own directory."""
    jdir, tdir = tmp_path_factory.mktemp("jax_data"), tmp_path_factory.mktemp("port_data")
    jpipe = JDataPipeline.build(str(jdir), **BUILD)
    tpipe = DataPipeline.build(str(tdir), **BUILD)
    return jdir, jpipe, tdir, tpipe


def _work(batch, rng):
    """A numpy work_fn that draws from the per-batch rng, so the rng's
    keying by (seed, epoch, batch) is compared too."""
    return {**batch, "draw": rng.integers(0, 1 << 30, size=4)}


def _assert_same(got, want, where):
    assert sorted(got) == sorted(want), where
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and np.array_equal(g, w), (where, k)


def test_build_writes_the_jax_files(built):
    jdir, jpipe, tdir, tpipe = built
    names = ["raw.jsonl", "tokenizer.json"]
    names += [p.name for p in sorted((jdir).glob("packed.*.npy"))]
    assert len(names) >= 4
    for name in names:
        assert filecmp.cmp(jdir / name, tdir / name, shallow=False), name
    assert tpipe.ds.n_examples == jpipe.ds.n_examples
    assert tpipe.batches_per_epoch == jpipe.batches_per_epoch
    assert tpipe.ds.staged and tpipe.tokenizer.merges == jpipe.tokenizer.merges


@pytest.mark.parametrize("process_count,n_workers", [(1, 1), (1, 3), (2, 1), (2, 3)])
def test_batches_equal_jax_across_an_epoch_boundary(built, process_count, n_workers):
    _, jpipe, _, tpipe = built
    for work_fn in (None, _work):
        for pidx in range(process_count):
            kw = dict(seed=SEED, process_index=pidx, process_count=process_count,
                      n_workers=n_workers, work_fn=work_fn)
            jp = JDataPipeline(jpipe.ds, BATCH, **kw)
            tp = DataPipeline(tpipe.ds, BATCH, **kw)
            n = 2 * tp.batches_per_epoch + 1
            assert tp.batches_per_epoch == jp.batches_per_epoch
            with jp, tp:
                it = tp.host_batches()
                for k in range(n):
                    want = jp.peek_batch(k)
                    _assert_same(tp.peek_batch(k), want, (pidx, k))
                    _assert_same(next(it), want, ("host_batches", pidx, k))


def test_pipeline_state_and_restore_refusals_match_jax(built):
    _, jpipe, _, tpipe = built
    jp = JDataPipeline(jpipe.ds, BATCH, seed=SEED, process_index=1, process_count=2)
    tp = DataPipeline(tpipe.ds, BATCH, seed=SEED, process_index=1, process_count=2)
    for step in (0, 7, tp.batches_per_epoch, 2 * tp.batches_per_epoch + 3):
        assert tp.state_at(step).to_json() == jp.state_at(step).to_json()
        assert PipelineState.from_json(jp.state_at(step).to_json()) == tp.state_at(step)
    good = jp.state_at(11).to_json()
    assert tp.restore(good).start_step == jp.restore(good).start_step == 11
    assert tp.restore(PipelineState.from_json(good)).start_step == 11
    for bad in ({"n_examples": good["n_examples"] + 1}, {"batch_size": BATCH * 2},
                {"process_count": 1}, {"seed": SEED + 1}):
        state = {**good, **bad}
        with pytest.raises(ValueError) as jerr:
            jp.restore(state)
        with pytest.raises(ValueError) as terr:
            tp.restore(state)
        assert str(terr.value) == str(jerr.value)
    assert tp.start_step == 11        # a refused restore moves nothing


def test_device_prefetch_keeps_order_content_and_end():
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, 100, (2, 5)).astype(np.int32),
                "loss_mask": torch.rand(2, 5)} for _ in range(5)]
    for size in (1, 2, 4, 8):
        pf = DevicePrefetch(iter(batches), device="cpu", size=size)
        got = list(pf)
        assert pf.puts == len(got) == len(batches)
        for g, w in zip(got, batches):
            assert isinstance(g["tokens"], torch.Tensor) and g["tokens"].dtype == torch.int32
            assert torch.equal(g["tokens"], torch.from_numpy(w["tokens"]))
            assert torch.equal(g["loss_mask"], w["loss_mask"])
    assert list(DevicePrefetch(iter([]), device="cpu")) == []
    short = list(DevicePrefetch(iter(batches[:1]), device="cpu", size=4))
    assert len(short) == 1 and torch.equal(short[0]["loss_mask"], batches[0]["loss_mask"])


def test_device_batches_of_the_pipeline_on_the_cpu(built):
    _, _, _, tpipe = built
    tp = DataPipeline(tpipe.ds, BATCH, seed=SEED, work_fn=_work, device_prefetch=3)
    with tp:
        tp.restore(tp.state_at(4))
        prefetch = tp.device_batches("cpu")
        for k, batch in zip(range(6), prefetch):
            _assert_same({key: t.numpy() for key, t in batch.items()}, tp.peek_batch(k), k)
        assert prefetch.size == 3 and prefetch.puts >= 6
        assert not prefetch.loader._stop.is_set()
        prefetch.close()
        assert prefetch.loader._stop.is_set()


def test_device_prefetch_hands_out_a_leaf_already_on_the_device_as_it_is():
    """A tensor already on the target device is neither copied nor
    staged; a numpy leaf beside it is wrapped."""
    on_dev = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    batches = [{"tokens": on_dev, "mask": np.ones((2, 3), np.float32)}]
    (got,) = list(DevicePrefetch(iter(batches), device="cpu"))
    assert got["tokens"] is on_dev
    assert isinstance(got["mask"], torch.Tensor) and torch.equal(got["mask"], torch.ones(2, 3))
    assert on_device(on_dev, torch.device("cpu"))
    assert not on_device(torch.empty(1, device="meta"), torch.device("cpu"))


def test_device_prefetch_needs_the_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePrefetch(iter([]))

"""The port's continuous-batching engine: against the JAX package's engine
with the same weights and requests (identical tokens in both prefill modes,
with every greedy choice clear of a tie), and the behaviours that
tests/test_serve_engine.py asserts of the reference.

A greedy token is only as certain as its margin: the port and the JAX
package compute float32 logits that differ in the last bits (about 1e-6
here), so every step's top-2 margin on the port is asserted above 1e-4,
a hundred times that, before equal tokens are read as agreement.
"""
import jax
import numpy as np
import pytest
import torch

from repro.models import build_model as jax_build
from repro.models import get_config as jax_get_config
from repro.models import reduced_config as jax_reduced
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch import bridge
from repro_torch.launch import serve as launcher
from repro_torch.models import build_model, get_config, reduced_config
from repro_torch.serve import Request, ServeEngine
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

MARGIN_FLOOR = 1e-4


@pytest.fixture(scope="module")
def engine_setup():
    cfg = reduced_config(get_config("llama3.2-1b"))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    return cfg, model, params


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, port params): same weights."""
    jmodel = jax_build(jax_reduced(jax_get_config("llama3.2-1b")))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(reduced_config(get_config("llama3.2-1b")))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    bridge.load_lm_params(params, jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, model, params


class _MarginEngine(ServeEngine):
    """The port's engine, recording each step's smallest top-2 margin."""

    def _greedy(self, logits):
        top = torch.topk(logits, 2, dim=-1).values
        self.margins.append(float((top[:, 0] - top[:, 1]).min()))
        return super()._greedy(logits)


def _prompts(seed, lengths, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, n).astype(np.int32) for n in lengths]


@pytest.mark.parametrize("mode", ["fused", "loop"])
def test_tokens_match_the_reference_engine(pair, mode):
    jmodel, jparams, model, params = pair
    prompts = _prompts(2, (5, 1, 7, 3, 6, 9))
    jeng = JaxEngine(jmodel, jparams, max_batch=3, max_seq=48,
                     prefill_mode=mode)
    teng = _MarginEngine(model, params, max_batch=3, max_seq=48,
                         prefill_mode=mode)
    teng.margins = []
    outs = []
    for eng, req_cls in ((jeng, JaxRequest), (teng, Request)):
        reqs = [req_cls(rid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        done = eng.run_until_drained()
        assert sorted(r.rid for r in done) == list(range(len(reqs)))
        outs.append([tuple(r.out_tokens) for r in reqs])
    assert outs[0] == outs[1]
    assert min(teng.margins) > MARGIN_FLOOR


def test_requests_complete_and_respect_max_new(engine_setup):
    cfg, model, params = engine_setup
    engine = ServeEngine(model, params, max_batch=3, max_seq=48)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=7)
            for i, p in enumerate(_prompts(0, [5] * 7, cfg.vocab))]
    for r in reqs:
        engine.submit(r)
    steps = 0
    while (engine.waiting or engine.n_active) and steps < 500:
        engine.step()
        steps += 1
    assert all(r.done for r in reqs)
    assert all(1 <= len(r.out_tokens) <= 7 for r in reqs)


def test_continuous_batching_overlaps_requests(engine_setup):
    """More requests than slots: the engine reuses freed slots."""
    cfg, model, params = engine_setup
    engine = ServeEngine(model, params, max_batch=2, max_seq=32)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=4)
            for i, p in enumerate(_prompts(1, [4] * 5, cfg.vocab))]
    for r in reqs:
        engine.submit(r)
    peak_active, steps = 0, 0
    while (engine.waiting or engine.n_active) and steps < 500:
        engine.step()
        peak_active = max(peak_active, engine.n_active)
        steps += 1
    assert all(r.done for r in reqs)
    assert peak_active == 2


def test_fused_prefill_matches_token_by_token(engine_setup):
    cfg, model, params = engine_setup
    prompts = _prompts(2, (5, 1, 7, 3, 6), cfg.vocab)
    outs = {}
    for mode in ("loop", "fused"):
        engine = ServeEngine(model, params, max_batch=2, max_seq=48,
                             prefill_mode=mode)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            engine.submit(r)
        done = engine.run_until_drained()
        assert sorted(r.rid for r in done) == list(range(len(reqs)))
        outs[mode] = [tuple(r.out_tokens) for r in reqs]
    assert outs["fused"] == outs["loop"]


def test_run_until_drained_returns_completed(engine_setup):
    cfg, model, params = engine_setup
    engine = ServeEngine(model, params, max_batch=2, max_seq=32)
    reqs = [Request(rid=i, prompt=np.asarray([4 + i, 11], np.int32),
                    max_new_tokens=3) for i in range(3)]
    for r in reqs:
        engine.submit(r)
    done = engine.run_until_drained()
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(r.done for r in done)
    assert engine.run_until_drained() == []


def test_greedy_decode_is_deterministic(engine_setup):
    cfg, model, params = engine_setup
    outs = []
    for _ in range(2):
        engine = ServeEngine(model, params, max_batch=1, max_seq=32)
        req = Request(rid=0, prompt=np.asarray([5, 9, 12], np.int32),
                      max_new_tokens=6)
        engine.submit(req)
        engine.run_until_drained()
        outs.append(tuple(req.out_tokens))
    assert outs[0] == outs[1]


def test_engine_refuses_bad_mode_and_mesh(engine_setup):
    cfg, model, params = engine_setup
    with pytest.raises(ValueError, match="prefill_mode"):
        ServeEngine(model, params, prefill_mode="scan")
    with pytest.raises(TypeError, match="device.Mesh"):
        ServeEngine(model, params, mesh=object())


def test_launcher_serves_on_the_cpu(capsys):
    launcher.main(["--reduced", "--device", "cpu", "--requests", "3",
                   "--max-new", "4"])
    out = capsys.readouterr().out
    assert out.startswith("[serve] 3/3 requests, 12 tokens")


def test_launcher_defaults_to_the_card():
    args = launcher.parse_args([])
    assert (args.arch, args.device, args.requests, args.max_new,
            args.max_batch, args.max_seq) == ("llama3.2-1b", "cuda", 12, 16,
                                              4, 256)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            launcher.build(launcher.parse_args(["--reduced"]))

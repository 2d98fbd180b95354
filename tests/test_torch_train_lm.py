"""LM training on the port: gradients (the other half of the archs of
``test_torch_train_grads.py``), rematerialization, the train step and the
LM training CLI.

* Four steps of ``build_train_step`` lower each reduced arch's loss, as
  ``tests/test_models_smoke.py::test_train_step_decreases_loss`` requires
  of the reference (lr 3e-3, warmup 1).
* Remat sits where the reference's ``jax.checkpoint`` does: one
  checkpoint per body period under ``remat=True``, one per loss chunk,
  one per query block of the blocked attention (sequences above 512) and
  one per 64 steps of the SSM / xLSTM time loops (sequences above 64);
  the values and gradients are those of a run without any checkpoint,
  bit for bit.
* ``python -m repro_torch.launch.train`` prints the reference CLI's
  lines, its loss falls, and without a card it raises instead of running
  on the CPU.
"""

import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.models.layers import ATTN_Q_BLOCK
from repro_torch.train import AdamWConfig, adamw_init, value_and_grad
from repro_torch.train.tree import flatten_with_paths

from _lm_parity import check_arch_gradients

ARCHS = ["qwen3-8b", "qwen2.5-14b", "h2o-danube-1.8b",
         "llama-3.2-vision-11b", "seamless-m4t-large-v2"]


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax(arch):
    check_arch_gradients(arch)


def test_the_two_files_cover_every_arch():
    from test_torch_train_grads import ARCHS as OTHERS

    assert sorted(ARCHS + OTHERS) == sorted(list_archs())


def _inputs(cfg, seq=16, batch=2, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (batch, seq))
    memory = None
    if cfg.frontend_tokens:
        memory = torch.as_tensor(rng.standard_normal(
            (batch, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
        ).to(torch.bfloat16)
    return tokens, memory


@pytest.mark.parametrize("arch", list_archs())
def test_train_step_decreases_loss(arch):
    cfg = reduced(get_config(arch))
    params = tlm.init_lm(cfg, torch.Generator().manual_seed(1), "cpu")
    tokens, memory = _inputs(cfg)
    step = tsteps.build_train_step(
        cfg, AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=10),
        device="cpu")
    opt = adamw_init(params)
    losses = []
    for _ in range(4):
        params, opt, metrics = step(params, opt, tokens, memory)
        losses.append(float(metrics["loss"]))
        assert set(metrics) == {"loss", "grad_norm", "lr"}
    assert np.isfinite(losses).all(), (arch, losses)
    assert losses[-1] < losses[0], (arch, losses)
    assert int(opt.step) == 4


def test_train_step_skips_a_non_finite_loss():
    """A NaN loss leaves the params and moments as they were (the update
    is in place; the trainer then restores a checkpoint)."""
    cfg = reduced(get_config("qwen3-8b"))
    params = tlm.init_lm(cfg, torch.Generator().manual_seed(1), "cpu")
    params["final_norm"].fill_(float("nan"))
    before = [t.clone() for _, t in flatten_with_paths(params)]
    opt = adamw_init(params)
    step = tsteps.build_train_step(cfg, device="cpu")
    params, opt, metrics = step(params, opt, _inputs(cfg)[0])
    assert not np.isfinite(float(metrics["loss"]))
    assert int(opt.step) == 0
    for (_, t), b in zip(flatten_with_paths(params), before):
        assert torch.equal(t, b) or torch.isnan(b).all()


class _Checkpoints:
    """Counts ``torch.utils.checkpoint.checkpoint`` calls (``layers.remat``
    imports it at each call)."""

    def __init__(self, monkeypatch, run: bool = True):
        import torch.utils.checkpoint as tuc

        self.n = 0
        real = tuc.checkpoint

        def counted(fn, *args, **kw):
            self.n += 1
            return real(fn, *args, **kw) if run else fn(*args)

        monkeypatch.setattr(tuc, "checkpoint", counted)


@pytest.mark.parametrize("arch,seq", [("internlm2-1.8b", 2 * ATTN_Q_BLOCK),
                                      ("xlstm-1.3b", 2 * tssm.SCAN_CHUNK),
                                      ("jamba-1.5-large-398b",
                                       2 * tssm.SCAN_CHUNK)])
def test_remat_sites_are_the_references(monkeypatch, arch, seq):
    """Forward checkpoints under autograd: one per loss chunk, per query
    block of a self-attention layer at seq > 512, per 64 time steps of a
    mamba / mLSTM / sLSTM layer at seq > 64, and one per body period with
    ``remat=True``; none without autograd."""
    cfg = reduced(get_config(arch))
    params = tlm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens, memory = _inputs(cfg, seq=seq, batch=1)
    tokens = torch.as_tensor(tokens)
    periods = tlm.n_body_periods(cfg)
    kinds = [k.split("+")[0] for k in cfg.pattern] * periods
    per_layer = {"attn": seq // ATTN_Q_BLOCK if seq > ATTN_Q_BLOCK else 0,
                 "mamba": seq // tssm.SCAN_CHUNK, "mlstm": seq // tssm.SCAN_CHUNK,
                 "slstm": seq // tssm.SCAN_CHUNK}
    chunks = seq // min(cfg.loss_chunk, seq)
    for remat in (False, True):
        count = _Checkpoints(monkeypatch)
        with torch.enable_grad():
            tlm.lm_loss(params, cfg, tokens, memory, remat=remat)
        want = chunks + sum(per_layer.get(k, 0) for k in kinds) + (
            periods if remat else 0)
        assert count.n == want, (remat, count.n, want)
    count = _Checkpoints(monkeypatch)
    with torch.no_grad():
        tlm.lm_loss(params, cfg, tokens, memory, remat=True)
    assert count.n == 0


@pytest.mark.parametrize("arch,seq", [("internlm2-1.8b", 2 * ATTN_Q_BLOCK),
                                      ("xlstm-1.3b", 2 * tssm.SCAN_CHUNK),
                                      ("jamba-1.5-large-398b",
                                       2 * tssm.SCAN_CHUNK)])
def test_remat_changes_memory_not_values(monkeypatch, arch, seq):
    """At sequences long enough for every remat site, the loss and
    gradients with checkpoints equal those with every checkpoint replaced
    by a plain call, bit for bit."""
    cfg = reduced(get_config(arch))
    params = tlm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens, memory = _inputs(cfg, seq=seq, batch=1)
    grad = value_and_grad(lambda p: tlm.lm_loss(
        p, cfg, torch.as_tensor(tokens), memory, remat=True))
    loss, grads = grad(params)
    _Checkpoints(monkeypatch, run=False)
    plain_loss, plain = grad(params)
    assert torch.equal(loss, plain_loss)
    for (k, a), (_, b) in zip(flatten_with_paths(grads),
                              flatten_with_paths(plain)):
        assert torch.equal(a, b), k


def _run_reference_cli(argv, monkeypatch, capsys):
    from repro.launch import train as jtrain

    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    jtrain.main()
    return capsys.readouterr().out.strip().splitlines()


def test_train_cli_prints_the_references_lines(tmp_path, monkeypatch,
                                              capsys):
    argv = ["--reduced", "--steps", "6", "--batch", "4", "--seq", "32"]
    want = _run_reference_cli(argv + ["--ckpt-dir", str(tmp_path / "j")],
                              monkeypatch, capsys)
    out = ttrain.main(argv + ["--ckpt-dir", str(tmp_path / "t")],
                      device="cpu")
    got = capsys.readouterr().out.strip().splitlines()
    assert got[0] == want[0] == ("internlm2-1.8b-smoke: "
                                 f"{out['n_params'] / 1e6:.1f}M params, "
                                 "batch 4 x seq 32")
    # the trainer's step log; a "straggler step" line depends on timing
    def steps(lines):
        return [line.split(" loss=")[0] for line in lines
                if line.startswith("[trainer] step ")]

    assert steps(got) == steps(want) == ["[trainer] step 5/6"]
    assert got[-1].startswith("done: 6 steps, loss ")
    report = out["report"]
    assert report.steps_done == 6 and report.losses[-1] < report.losses[0]
    assert out["device"] == "cpu"
    from repro_torch.train import checkpoint as tckpt

    assert tckpt.latest_step(str(tmp_path / "t")) == 6


def test_train_cli_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsteps.build_train_step(reduced(get_config("qwen3-8b")))

"""The ``lm_loss`` gradient of the port against ``jax.grad``, per arch.

For each reduced arch, the reference's weights (carried across as numpy)
and ``tests/test_models_smoke.py``'s inputs go through
``jax.value_and_grad(lm_loss(remat=True))`` and through the port's
``train.value_and_grad`` of its ``lm_loss`` at ``remat=False`` and
``remat=True``:

* the port's two remat settings give the same loss and gradients, bit for
  bit (remat changes memory, not values);
* the loss is within LOSS_REL of the reference's;
* every gradient leaf is within 2e-2 of max|reference grad| of that leaf,
  or, where the reference's own gradient of that leaf moves more when 1%
  of its embedding entries move one bf16 ulp (the largest move over four
  draws, computed here), within twice that move
  (``_lm_parity.grad_case``), up to 0.25.  Near-tied expert choices
  (deepseek's MoE) and the exponential gates of xlstm move the
  reference's own gradients by up to 47% and 172% under that
  perturbation: those leaves are held by their cosine distance, within
  twice the reference's own (at most 0.5), and their norm, within a
  factor 1.5 (``repro_torch.train.grad.hold_leaf``);
* the bar fails a leaf that is zeroed or sign-flipped, at a leaf of
  either kind, and a gradient whose first body period lost its backward
  (its block treated as a constant: the residual path alone carries the
  gradient through it).

The archs are split between this file and ``test_torch_train_lm.py`` so
that they run on two workers.
"""

import pytest
import torch

from _lm_parity import check_arch_gradients, gradient_failures, port_gradients

ARCHS = ["deepseek-v2-lite-16b", "xlstm-1.3b", "jamba-1.5-large-398b",
         "mixtral-8x22b", "internlm2-1.8b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax(arch):
    check_arch_gradients(arch)


# A leaf the reference holds steadily (a relative bar) and one it moves
# by 172% (xlstm's forget gate, a cosine bar), and deepseek's expert FFN.
WRONG_LEAVES = [("internlm2-1.8b", "['embed']"),
                ("internlm2-1.8b", "['blocks']/['b0']/['mix']/['wq']"),
                ("xlstm-1.3b", "['blocks']/['b4']/['mix']/['wf']"),
                ("deepseek-v2-lite-16b", "['blocks']/['b0']/['ffn']/['up']")]


@pytest.mark.parametrize("wrong", ["zeroed", "sign_flipped"])
@pytest.mark.parametrize("arch,leaf", WRONG_LEAVES)
def test_the_bar_fails_a_wrong_leaf(arch, leaf, wrong):
    _, got = port_gradients(arch)
    assert leaf in dict(got) and not gradient_failures(arch, got)
    bad = [(k, (torch.zeros_like(g) if wrong == "zeroed" else -g)
            if k == leaf else g) for k, g in got]
    assert list(gradient_failures(arch, bad)) == [leaf]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "xlstm-1.3b",
                                  "deepseek-v2-lite-16b"])
def test_the_bar_fails_a_lost_remat_segment(arch, monkeypatch):
    from repro_torch.models import layers

    real, lost = layers.remat, []

    def lossy(fn, *args):
        out = real(fn, *args)
        if fn.__name__ == "body" and not lost:
            lost.append(fn)
            return args[0] + (out - args[0]).detach()
        return out

    monkeypatch.setattr(layers, "remat", lossy)
    _, got = port_gradients.__wrapped__(arch)
    assert lost
    failed = gradient_failures(arch, got)
    assert "['embed']" in failed, sorted(failed)

"""The port's optimizers against the reference's, on the CPU.

Parameters and gradients are made with numpy from a seed and handed to
both packages as the same fp32 values; each optimizer takes five steps
on fixed gradients.  Tolerance: rel 1e-6 (atol 1e-7 where a value
crosses zero), the same fp32 operations taken in PyTorch's order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.optim import optimizers as JO

import repro_torch.configs as TC
from repro_torch.optim import optimizers as TO

TOL = dict(rtol=1e-6, atol=1e-7)
#: a matrix (factored under Adafactor), a vector, a 3-d stack, a column
SHAPES = {"w": (16, 24), "b": (24,), "stack": (3, 8, 12), "col": (10, 1)}


def _tree(seed: int, scale: float = 1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, dtype=np.float32)


def _assert_tree(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree(got[k], want[k])
        else:
            np.testing.assert_allclose(_np(got[k]), _np(want[k]), **TOL,
                                       err_msg=k)


def _run_both(jopt, topt, steps: int = 5):
    params = _tree(0)
    grads = [_tree(10 + i, 0.1) for i in range(steps)]
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jp, js = jopt.update(jp, {k: jnp.asarray(v) for k, v in g.items()},
                             js, jnp.zeros(()))
        tp, ts = topt.update(tp, {k: torch.from_numpy(v.copy())
                                  for k, v in g.items()}, ts,
                             torch.zeros(()))
    return jp, js, tp, ts


@pytest.mark.parametrize("lr", ["constant", "cosine"])
def test_adamw_five_steps_match_reference(lr):
    jlr = 1e-2 if lr == "constant" else JO.cosine_schedule(1e-2, 2, 10)
    tlr = 1e-2 if lr == "constant" else TO.cosine_schedule(1e-2, 2, 10)
    jp, js, tp, ts = _run_both(JO.adamw(jlr), TO.adamw(tlr))
    _assert_tree(tp, jp)
    assert int(ts["step"]) == int(js["step"]) == 5
    for key in ("m", "v", "master"):
        _assert_tree(ts[key], js[key])


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adafactor_five_steps_match_reference(weight_decay):
    jp, js, tp, ts = _run_both(JO.adafactor(1e-2, weight_decay=weight_decay),
                               TO.adafactor(1e-2, weight_decay=weight_decay))
    _assert_tree(tp, jp)
    assert int(ts["step"]) == 5
    # factored second moments where the reference factors them
    assert set(ts["v"]["w"]) == {"vr", "vc"} and set(ts["v"]["b"]) == {"v"}
    assert set(ts["v"]["col"]) == {"v"}
    _assert_tree(ts["v"], js["v"])


def test_adamw_keeps_bf16_params_with_fp32_master():
    params = {k: torch.from_numpy(v).to(torch.bfloat16)
              for k, v in _tree(0).items()}
    opt = TO.adamw(1e-3)
    state = opt.init(params)
    assert all(m.dtype == torch.float32 for m in state["master"].values())
    new, state = opt.update(params, {k: torch.ones_like(p)
                                     for k, p in params.items()},
                            state, torch.zeros(()))
    assert all(p.dtype == torch.bfloat16 for p in new.values())
    # the new params are copies, not views of the master
    new["w"].zero_()
    assert float(state["master"]["w"].abs().sum()) > 0


@pytest.mark.parametrize("max_norm", [0.5, 1.0, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(3)
    jg, jn = JO.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()},
                                    max_norm)
    tg, tn = TO.clip_by_global_norm({k: torch.from_numpy(v.copy())
                                     for k, v in g.items()}, max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(TO.global_norm(tg)),
                               float(JO.global_norm(jg)), rtol=1e-6)
    _assert_tree(tg, jg)


def test_cosine_schedule_matches_reference():
    j, t = JO.cosine_schedule(3e-4, 20, 100), TO.cosine_schedule(3e-4, 20,
                                                                  100)
    for step in (0, 1, 10, 19, 20, 21, 50, 99, 100, 150):
        np.testing.assert_allclose(float(t(torch.tensor(step))),
                                   float(j(jnp.asarray(step))), rtol=1e-6,
                                   atol=1e-12)


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-7b", "grok-1-314b",
                                  "jamba-1.5-large-398b", "mamba2-1.3b"])
def test_for_config_picks_as_the_reference(arch):
    """AdamW below 1e11 parameters, Adafactor above: the full configs of
    grok-1 (314B) and jamba (398B) take Adafactor."""
    assert TO.for_config(TC.get(arch)).name == \
        JO.for_config(RC.get(arch)).name
    assert TO.for_config(TC.get(arch)).name == (
        "adafactor" if arch in ("grok-1-314b", "jamba-1.5-large-398b")
        else "adamw")

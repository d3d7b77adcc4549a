"""The port's training path against the reference, on the CPU.

Weights come from the reference's ``init`` (constant leaves randomised)
and are carried into the port with ``model_params_from_reference``;
optimizer states with ``optimizer_state_from_reference``; batches are
seeded numpy arrays handed to both.  All fp32 at smoke size; on the CPU
``flash_attention`` and ``ssd_chunk`` take their plain versions, which
autograd differentiates.

Tolerances:
  * loss: rel 2e-5 (fp32 reassociation, as the forward tests);
  * gradients: each parameter's within GRAD_TOL of its own max |grad|
    (the backward sums the same products in another order; MoE routes
    are equal, so no expert changes);
  * two optimizer steps: parameters within 2e-5 (rtol and atol), Adam's
    and Adafactor's normalisation of the same gradients.

The reference's own trainer tests fail on this tree (its sharding layer
raises on one device), so the port's ``Trainer`` is held to the
properties those tests state, and to the reference's ``make_train_step``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as JST
from repro.models import api as japi
from repro.optim import optimizers as JO

from repro_torch.carry import optimizer_state_from_reference
from repro_torch.kernels import build
from repro_torch.launch import steps as TST
from repro_torch.models import api as tapi
from repro_torch.optim import optimizers as TO
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from test_torch_transformer import _carried


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t).astype(np.float32)

GRAD_TOL = 1e-4
ARCHS = ["olmo-1b", "qwen2-7b", "qwen3-14b", "llava-next-34b",
         "qwen2-moe-a2.7b", "grok-1-314b", "whisper-small", "mamba2-1.3b",
         "jamba-1.5-large-398b"]


def _batch(cfg, b: int = 2, s: int = 32, seed: int = 5):
    """The same batch for both packages: (reference's, port's)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (b, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v.copy()) for k, v in out.items()})


def _as_port(tree, cfg_t):
    """A tree over the reference's parameters as a name -> tensor dict
    over the port's."""
    return optimizer_state_from_reference({"step": np.zeros((), np.int32),
                                           "t": tree}, cfg_t)["t"]


def _port_grads(cfg_t, model, batch):
    model.requires_grad_(True)
    named = dict(model.named_parameters())
    loss = tapi.loss_fn(cfg_t, model, batch)
    grads = torch.autograd.grad(loss, list(named.values()),
                                allow_unused=True)
    return loss.detach(), dict(zip(named, grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(arch):
    cfg_j, cfg_t, params, model = _carried(arch)
    bj, bt = _batch(cfg_j)
    want_loss, want = jax.value_and_grad(
        lambda p: japi.loss_fn(cfg_j, p, bj))(params)
    want = _as_port(jax.tree_util.tree_map(np.asarray, want), cfg_t)
    loss, got = _port_grads(cfg_t, model, bt)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=2e-5)
    assert set(got) == set(want)
    for name, w in want.items():
        g = torch.zeros_like(w) if got[name] is None else got[name]
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= GRAD_TOL * max(scale, 1e-6), (name, err, scale)


def _opt_pair(kind: str):
    if kind == "adamw":
        return JO.adamw(1e-3), TO.adamw(1e-3)
    return JO.adafactor(1e-2), TO.adafactor(1e-2)


@pytest.mark.parametrize("arch,kind", [("olmo-1b", "adamw"),
                                       ("qwen2-moe-a2.7b", "adamw"),
                                       ("qwen2-7b", "adafactor"),
                                       ("whisper-small", "adamw"),
                                       ("jamba-1.5-large-398b", "adamw")])
def test_two_train_steps_match_reference(arch, kind):
    """Two ``make_train_step`` steps from one carried AdamW or Adafactor
    state (the reference's after one step of its own, so moments are
    not zero): losses, grad norms, parameters and states agree."""
    cfg_j, cfg_t, params, model = _carried(arch)
    jopt, topt = _opt_pair(kind)
    jstep = JST.make_train_step(cfg_j, jopt)
    tstep = TST.make_train_step(cfg_t, topt, device="cpu")
    jstate = jopt.init(params)
    params, jstate, _ = jstep(params, jstate, _batch(cfg_j, seed=20)[0])
    with torch.no_grad():
        for name, p in _as_port(jax.tree_util.tree_map(np.asarray, params),
                                cfg_t).items():
            model.get_parameter(name).copy_(p)
    tstate = optimizer_state_from_reference(
        jax.tree_util.tree_map(np.asarray, jstate), cfg_t)
    for seed in (21, 22):
        bj, bt = _batch(cfg_j, seed=seed)
        params, jstate, jm = jstep(params, jstate, bj)
        model, tstate, tm = tstep(model, tstate, bt)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=2e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    # Adam divides each gradient by its own running RMS: where a gradient
    # is near zero, reassociation in it moves that element's update by a
    # share of the step size, as the reference's accumulation test says.
    # So: at most 1e-4 of the elements past 2e-5, none by three steps
    want = _as_port(jax.tree_util.tree_map(np.asarray, params), cfg_t)
    total = past = 0
    for name, p in model.named_parameters():
        diff = np.abs(_np(p) - _np(want[name]))
        bad = diff > 2e-5 * (1 + np.abs(_np(want[name])))
        past += int(bad.sum())
        total += diff.size
        assert float(diff.max()) <= 3 * 1e-2, name
    assert past <= 1e-4 * total, (past, total)
    assert int(tstate["step"]) == int(jstate["step"]) == 3


def _state(cfg_t, model, opt):
    return opt.init({k: p.detach() for k, p in model.named_parameters()})


def _clone(model):
    import copy
    return copy.deepcopy(model)


def test_grad_accumulation_matches_full_batch():
    """``accum_steps=2`` gives the update of ``accum_steps=1`` (the
    reference's test_grad_accumulation_matches_full_batch property)."""
    _, cfg_t, _, model = _carried("olmo-1b")
    _, bt = _batch(cfg_t, b=4)
    opt = TO.adamw(1e-3)
    m1, m2 = _clone(model), _clone(model)
    p1, _, r1 = TST.make_train_step(cfg_t, opt, accum_steps=1,
                                    device="cpu")(m1, _state(cfg_t, m1, opt),
                                                  bt)
    p2, _, r2 = TST.make_train_step(cfg_t, opt, accum_steps=2,
                                    device="cpu")(m2, _state(cfg_t, m2, opt),
                                                  bt)
    assert float(r1["loss"]) == pytest.approx(float(r2["loss"]), rel=1e-3)
    assert float(r1["grad_norm"]) == pytest.approx(float(r2["grad_norm"]),
                                                   rel=2e-2)
    total = mismatched = 0
    for a, b in zip(p1.parameters(), p2.parameters()):
        bad = ~np.isclose(_np(a), _np(b), rtol=2e-2, atol=2e-3)
        mismatched += int(bad.sum())
        total += a.numel()
    assert mismatched / total < 5e-3, (mismatched, total)


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-moe-a2.7b",
                                  "whisper-small"])
def test_remat_on_and_off_give_the_same_gradients(arch):
    """Rematerialised blocks recompute the same forward: equal loss and
    gradients to fp32 reassociation."""
    cfg_j, cfg_t, _, model = _carried(arch)
    _, bt = _batch(cfg_t)
    assert cfg_t.remat
    l_on, g_on = _port_grads(cfg_t, model, bt)
    l_off, g_off = _port_grads(dataclasses.replace(cfg_t, remat=False),
                               model, bt)
    assert float(l_on) == pytest.approx(float(l_off), rel=1e-6)
    for name in g_on:
        torch.testing.assert_close(g_on[name], g_off[name], rtol=1e-5,
                                   atol=1e-6)


def test_remat_recomputes_each_block_in_the_backward(monkeypatch):
    """With ``remat`` each block's forward runs twice under a backward
    (once more to rebuild its activations); without it once."""
    from repro_torch.models import transformer as TT
    _, cfg_t, _, model = _carried("olmo-1b")
    _, bt = _batch(cfg_t)
    calls = {"n": 0}
    block_fwd = TT.block_fwd

    def counting(*args):
        calls["n"] += 1
        return block_fwd(*args)
    monkeypatch.setattr(TT, "block_fwd", counting)
    for remat, want in ((True, 2), (False, 1)):
        calls["n"] = 0
        _port_grads(dataclasses.replace(cfg_t, remat=remat), model, bt)
        assert calls["n"] == want * cfg_t.n_layers


# ---------------------------------------------------------------------- #
# the trainer
# ---------------------------------------------------------------------- #
def _trainer(tmp_path, arch="olmo-1b", steps=8, every=4):
    from repro_torch.configs import get_smoke
    cfg = get_smoke(arch)
    tcfg = TrainerConfig(total_steps=steps, checkpoint_every=every,
                         checkpoint_dir=str(tmp_path), log_every=1,
                         seq_len=32, global_batch=4,
                         async_checkpoint=False)
    return Trainer(cfg, tcfg, device="cpu")


def test_train_runs_and_checkpoints(tmp_path):
    tr = _trainer(tmp_path, steps=6, every=3)
    state = tr.train()
    assert state.step == 6
    assert tr.ckpt.latest_step() == 6
    assert tr.ckpt.steps() == [3, 6]
    losses = [m["loss"] for m in tr.metrics_log]
    assert len(losses) == 6 and all(np.isfinite(losses))


def test_restart_resumes_past_the_saved_step(tmp_path):
    tr1 = _trainer(tmp_path, steps=4, every=2)
    assert tr1.train().step == 4
    tr2 = _trainer(tmp_path, steps=8, every=2)
    s2 = tr2.train()
    assert s2.step == 8
    # it resumed, not restarted: the first logged step is past 4
    assert tr2.metrics_log[0]["step"] == 5


def test_resume_matches_uninterrupted(tmp_path):
    """Checkpoint and restore mid-run reproduce the uninterrupted loss
    (within rel 1e-4; on the CPU here it is the same bits)."""
    straight = _trainer(tmp_path / "a", steps=6, every=6)
    straight.train()
    part1 = _trainer(tmp_path / "b", steps=3, every=3)
    part1.train()
    part2 = _trainer(tmp_path / "b", steps=6, every=3)
    part2.train()
    ref, got = straight.metrics_log[-1], part2.metrics_log[-1]
    assert got["step"] == ref["step"] == 6
    assert got["loss"] == pytest.approx(ref["loss"], rel=1e-4)
    assert got["loss"] == ref["loss"]


def test_train_starts_from_a_given_state(tmp_path):
    """``train(state=...)`` runs from carried weights (no checkpoint
    read) and restores onto the trainer's device."""
    tr = _trainer(tmp_path, steps=2, every=2)
    state = tr.init_state(seed=3)
    first = {k: p.detach().clone() for k, p in
             state.params.named_parameters()}
    out = tr.train(state=state)
    assert out.step == 2 and out.params is state.params
    assert any(not torch.equal(first[k], p) for k, p in
               out.params.named_parameters())
    back = _trainer(tmp_path, steps=2).restore_or_init()
    assert back.step == 2
    for k, p in back.params.named_parameters():
        assert torch.equal(p, dict(out.params.named_parameters())[k])
    assert int(back.opt_state["step"]) == 2


def test_recovery_restores_after_failure(tmp_path):
    """NaN-poisoned parameters give a non-finite loss; the recovery loop
    reloads the checkpoint rather than propagate them."""
    tr = _trainer(tmp_path, steps=6, every=2)
    tr.train()
    calls = {"n": 0}
    orig_restore = tr.restore_or_init

    def sabotage():
        st = orig_restore()
        if calls["n"] == 0:
            calls["n"] += 1
            with torch.no_grad():
                for p in st.params.parameters():
                    p.fill_(float("nan"))
        return st

    tr.tcfg.total_steps = 8
    tr.restore_or_init = sabotage
    final = tr.run_with_recovery(max_restarts=2)
    assert final.step == 8 and calls["n"] == 1
    assert all(np.isfinite(m["loss"]) for m in tr.metrics_log)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_trainer_feeds_frames_in_the_model_dtype(tmp_path, dtype):
    """The trainer hands the step Whisper's frames in the model's dtype
    (the pipeline makes them fp32; fp32 frames would run a bf16 encoder
    in fp32), tokens and labels as the pipeline makes them; the step's
    own intake does the same to a numpy batch."""
    from repro_torch.configs import get_smoke
    cfg = dataclasses.replace(get_smoke("whisper-small"), dtype=dtype)
    tcfg = TrainerConfig(total_steps=1, checkpoint_dir=str(tmp_path),
                         seq_len=16, global_batch=2, async_checkpoint=False)
    tr = Trainer(cfg, tcfg, device="cpu")
    raw = tr.data.global_batch_at(0)
    assert raw["frames"].dtype == np.float32
    for got in (tr._device_batch(raw), TST.model_batch(cfg, raw, "cpu")):
        assert got["frames"].dtype == getattr(torch, dtype)
        assert tuple(got["frames"].shape) == (2, cfg.enc_frames,
                                              cfg.d_model)
        assert torch.equal(got["frames"], torch.from_numpy(
            raw["frames"]).to(getattr(torch, dtype)))
        assert torch.equal(got["tokens"], torch.from_numpy(raw["tokens"]))


def test_kernel_error_propagates_without_a_restart(tmp_path, monkeypatch):
    """A ``KernelError`` (a kernel that does not build or launch) is not
    a transient fault: ``run_with_recovery`` re-raises it at once, where
    a plain ``RuntimeError`` is retried."""
    tr = _trainer(tmp_path, steps=4, every=2)
    calls = {"n": 0}

    def failing(*args):
        calls["n"] += 1
        raise build.KernelError("flash_attention_bwd kernel launch failed")
    monkeypatch.setattr(tr, "_compiled_step", lambda: failing)
    with pytest.raises(build.KernelError):
        tr.run_with_recovery(max_restarts=2)
    assert calls["n"] == 1

    def flaky(*args):
        calls["n"] += 1
        raise RuntimeError("transient")
    calls["n"] = 0
    monkeypatch.setattr(tr, "_compiled_step", lambda: flaky)
    with pytest.raises(RuntimeError, match="transient"):
        tr.run_with_recovery(max_restarts=2)
    assert calls["n"] == 3


def test_step_for_picks_the_step_of_each_shape():
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs import get_smoke
    cfg = get_smoke("olmo-1b")
    names = {k: TST.step_for(cfg, s, device="cpu").__name__
             for k, s in SHAPES.items()}
    assert names == {"train_4k": "train_step", "prefill_32k": "prefill_step",
                     "decode_32k": "serve_step", "long_500k": "serve_step"}


def test_dp_or_tp_raise_in_the_launcher():
    """The launcher builds its mesh with ``make_mesh``: a data or tensor
    axis wider than the devices there are raises there, with the count."""
    from repro_torch.launch import train
    with pytest.raises(ValueError, match="mesh needs 2 devices; 1 cpu"):
        train.main(["--arch", "olmo-1b", "--smoke", "--dp", "2",
                    "--device", "cpu"])
    with pytest.raises(ValueError, match="mesh needs 2 devices; 1 cpu"):
        train.main(["--arch", "olmo-1b", "--smoke", "--tp", "2",
                    "--device", "cpu"])


@pytest.mark.parametrize("seq", ["128", "300", "0"])
def test_launcher_refuses_a_seq_off_the_ssd_chunk(seq):
    """Full-width Mamba2 splits its sequence into chunks of 256: a --seq
    that is no positive multiple of it raises before any model is built."""
    from repro_torch.launch import train
    with pytest.raises(ValueError, match="chunks of 256"):
        train.main(["--arch", "mamba2-1.3b", "--seq", seq, "--device", "cpu"])


@pytest.mark.parametrize("arch,smoke,want", [
    ("olmo-1b", False, 128), ("mamba2-1.3b", False, 256),
    ("mamba2-1.3b", True, 128), ("jamba-1.5-large-398b", False, 256)])
def test_launcher_default_seq_fits_the_chunk(arch, smoke, want):
    from repro_torch.configs import get, get_smoke
    from repro_torch.launch import train
    cfg = get_smoke(arch) if smoke else get(arch)
    assert train.train_seq(cfg, None) == want
    assert train.train_seq(cfg, 512) == 512

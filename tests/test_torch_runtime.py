"""The port's runtime helpers against the reference's, on the CPU:
health and elastic planning decide the same on scripted inputs; top-k
with error feedback and int8 quantisation give the same values."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import compression as JC
from repro.runtime import elastic as JE
from repro.runtime import health as JH

from repro_torch.runtime import compression as TC
from repro_torch.runtime import elastic as TE
from repro_torch.runtime import health as TH


def _script(mon, n_hosts):
    """Heartbeats with a straggler from report 3 on and a host that goes
    quiet; the decisions of each evaluation."""
    out = []
    for r in range(8):
        now = 100.0 + 10 * r
        for h in range(n_hosts):
            if h == 5 and r >= 4:
                continue                       # host 5 stops reporting
            lat = 1.0 + 0.01 * h
            if h == 2 and r >= 3:
                lat = 5.0                      # host 2 straggles
            mon.heartbeat(h, r, lat, now=now)
        d = mon.evaluate(now=now + 1)
        out.append((d.dead, d.stragglers, d.should_resize, d.healthy_count,
                    {h: rec.state.value for h, rec in mon.hosts.items()}))
    return out


@pytest.mark.parametrize("n_hosts", [8, 32])
def test_heartbeat_monitor_decides_as_reference(n_hosts):
    kw = dict(dead_after_s=25.0, straggler_factor=2.0, straggler_patience=2)
    assert _script(TH.HeartbeatMonitor(n_hosts, **kw), n_hosts) == \
        _script(JH.HeartbeatMonitor(n_hosts, **kw), n_hosts)


@pytest.mark.parametrize("chips,tp,per_pod", [(512, 16, 256), (500, 16, 256),
                                              (255, 16, 256), (64, 8, 32),
                                              (17, 16, 256)])
def test_plan_mesh_as_reference(chips, tp, per_pod):
    old_t = TE.plan_mesh(512, tp, per_pod)
    old_j = JE.plan_mesh(512, tp, per_pod)
    got = TE.plan_mesh(chips, tp, per_pod, old_plan=old_t)
    want = JE.plan_mesh(chips, tp, per_pod, old_plan=old_j)
    assert (got.pods, got.dp, got.tp, got.used_chips, got.idle_chips,
            got.global_batch_scale) == (want.pods, want.dp, want.tp,
                                        want.used_chips, want.idle_chips,
                                        want.global_batch_scale)


def _distinct(shape, seed):
    """Values with distinct magnitudes (a shuffled ramp, random signs), so
    no top-k tie can reorder."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    mag = (rng.permutation(n) + 1).astype(np.float32) / n
    return (mag * rng.choice([-1.0, 1.0], n)).reshape(shape) \
        .astype(np.float32)


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5])
def test_topk_compress_matches_reference(frac):
    g = _distinct((24, 40), 0)
    jv, ji, jr = JC.topk_compress(jnp.asarray(g), frac)
    tv, ti, tr = TC.topk_compress(torch.from_numpy(g), frac)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(tr.numpy(), np.asarray(jr))
    back = TC.topk_decompress(tv, ti, g.shape)
    assert np.array_equal(back.numpy(), np.asarray(
        JC.topk_decompress(jv, ji, g.shape)))
    assert np.array_equal((back + tr).numpy(), g)


def test_error_feedback_carries_the_residual_as_reference():
    grads = [{"w": _distinct((16, 16), s), "b": _distinct((32,), s + 50)}
             for s in range(3)]
    jef, tef = JC.ErrorFeedback(frac=0.1), TC.ErrorFeedback(frac=0.1)
    jres = jef.init({k: jnp.asarray(v) for k, v in grads[0].items()})
    tres = tef.init({k: torch.from_numpy(v) for k, v in grads[0].items()})
    for g in grads:
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        jcomp, jres = jef.compress(jg, jres)
        tcomp, tres = tef.compress(tg, tres)
        # from the second step on, g + residual can tie in magnitude:
        # the kept set is compared in index order
        for k in g:
            np.testing.assert_array_equal(tres[k].numpy(),
                                          np.asarray(jres[k]))
            ti, ji = tcomp[k]["idx"].numpy(), np.asarray(jcomp[k]["idx"])
            assert np.array_equal(np.sort(ti), np.sort(ji))
            np.testing.assert_array_equal(
                tcomp[k]["vals"].numpy()[np.argsort(ti)],
                np.asarray(jcomp[k]["vals"])[np.argsort(ji)])
        jd, td = jef.decompress(jcomp, jg), tef.decompress(tcomp, tg)
        for k in g:
            np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))


@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_int8_matches_reference(scale):
    g = np.random.default_rng(4).standard_normal((33, 17)).astype(
        np.float32) * scale
    jq, js = JC.int8_quantize(jnp.asarray(g))
    tq, ts = TC.int8_quantize(torch.from_numpy(g))
    assert tq.dtype == torch.int8
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-7)
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(TC.int8_dequantize(tq, ts).numpy(),
                               np.asarray(JC.int8_dequantize(jq, js)),
                               rtol=1e-6)

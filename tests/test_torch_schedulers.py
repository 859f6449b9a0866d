"""The port's six sampler families against the JAX package's.

Eager ``jnp`` on small arrays, no ``jax.jit``. Each case builds both
schedulers, holds the tables equal exactly, then runs
``scale_model_input``, ``add_noise`` and three chained ``step``s on seeded
numpy inputs; the JAX step draws its noise from a key, and the port's step
is given that very draw through ``noise=`` (``jax.random`` and
``torch.Generator`` give different numbers by design). Float32 on both
sides, relative L2 <= 1e-6: the port computes the step's scalar
coefficients in float64 where JAX keeps float32, a difference of about one
float32 rounding per coefficient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musev_tpu.ops.noise import make_noise as j_make_noise
from musev_tpu.schedulers import ScheduleConfig as JConfig
from musev_tpu.schedulers import create_scheduler as j_create
from musev_torch.schedulers import ScheduleConfig, create_scheduler


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: torch's OpenMP pool spun
    against the suite's other xdist workers. Restored after, as the setting
    is the process's and JAX shares it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = 1e-6  # relative L2, float32
SHAPE = (1, 3, 4, 4, 4)  # B, T, h, w, C
STEPS = 3  # the schedules' length: three chained steps reach the final one
ZERO_SNR = dict(rescale_betas_zero_snr=True, prediction_type="v_prediction",
                timestep_spacing="trailing")

# (id, name, ScheduleConfig fields, create kwargs)
CASES = [
    ("euler", "euler", {}, {}),
    ("euler_ancestral", "euler_ancestral", {}, {}),
    ("ddim", "ddim", {}, {}),
    ("ddpm", "ddpm", {}, {}),
    ("lcm", "lcm", {}, {}),
    ("dpmpp_2m", "dpmpp_2m", {}, {}),
    ("euler_churn", "euler", {}, dict(s_churn=1.0)),
    ("euler_churn_v_range", "euler", dict(prediction_type="v_prediction"),
     dict(s_churn=2.0, s_tmin=1.0, s_tmax=10.0, s_noise=1.003)),
    ("euler_log_linear", "euler", {}, dict(interpolation_type="log_linear")),
    ("ddim_eta", "ddim", {}, dict(eta=0.5)),
    ("ddim_zero_snr", "ddim", ZERO_SNR, {}),
]


def _pair(name, cfg, kw, steps=STEPS):
    return (j_create(name, steps, config=JConfig(**cfg), **kw),
            create_scheduler(name, steps, config=ScheduleConfig(**cfg), **kw))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _chain(js, ts, start=0, noise_type="video_fusion", w_ind_noise=0.5):
    """Steps start..end on both, each chained on its own output; returns
    the relative L2 of every (prev, pred_x0) pair."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(SHAPE, dtype=np.float32) * np.float32(ts.init_noise_sigma)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    multistep = getattr(js, "is_multistep", False)
    assert multistep == getattr(ts, "is_multistep", False)
    if multistep:
        sj, st = js.init_state(SHAPE), ts.init_state(SHAPE)
    errs = []
    for i in range(start, ts.num_inference_steps):
        out = rng.standard_normal(SHAPE, dtype=np.float32)
        key = jax.random.fold_in(jax.random.PRNGKey(0), i)
        drawn = np.array(j_make_noise(key, SHAPE, noise_type=noise_type,
                                       w_ind_noise=w_ind_noise))
        kw = dict(w_ind_noise=w_ind_noise, noise_type=noise_type)
        if multistep:
            xj, pj, sj = js.step(jnp.asarray(out), i, xj, sj, key=key, **kw)
            xt, pt, st = ts.step(torch.from_numpy(out), i, xt, st,
                                 noise=torch.from_numpy(drawn), **kw)
        else:
            xj, pj = js.step(jnp.asarray(out), i, xj, key=key, **kw)
            xt, pt = ts.step(torch.from_numpy(out), i, xt, noise=torch.from_numpy(drawn), **kw)
        assert xt.dtype == torch.float32 and np.isfinite(xt.numpy()).all()
        errs.append((_rel(xt.numpy(), xj), _rel(pt.numpy(), pj)))
    return errs


@pytest.mark.parametrize("name,cfg,kw", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_tables_match_jax_exactly(name, cfg, kw):
    js, ts = _pair(name, cfg, kw)
    assert type(ts).__name__ == type(js).__name__
    for field in ("timesteps", "sigmas", "alphas_cumprod"):
        if hasattr(js, field):
            want = getattr(js, field)
            got = getattr(ts, field)
            assert got.dtype == want.dtype, field
            np.testing.assert_array_equal(got, want, err_msg=field)
    assert ts.init_noise_sigma == js.init_noise_sigma
    for f in ("s_churn", "s_tmin", "s_tmax", "s_noise", "eta", "original_inference_steps"):
        if hasattr(js, f):
            assert getattr(ts, f) == getattr(js, f), f


@pytest.mark.parametrize("name,cfg,kw", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_steps_match_jax(name, cfg, kw):
    """scale_model_input and add_noise at every step, then three chained steps."""
    js, ts = _pair(name, cfg, kw)
    rng = np.random.default_rng(0)
    x, n = (rng.standard_normal(SHAPE, dtype=np.float32) for _ in range(2))
    for i in range(STEPS):
        assert _rel(ts.scale_model_input(torch.from_numpy(x), i).numpy(),
                    js.scale_model_input(jnp.asarray(x), i)) <= TOL
        assert _rel(ts.add_noise(torch.from_numpy(x), torch.from_numpy(n), i).numpy(),
                    js.add_noise(jnp.asarray(x), jnp.asarray(n), i)) <= TOL
    for i, (e_prev, e_x0) in enumerate(_chain(js, ts)):
        assert e_prev <= TOL and e_x0 <= TOL, (i, e_prev, e_x0)


def test_random_noise_type_and_weight_reach_the_draw():
    """The steps draw the noise type and weight they are given: Euler with
    churn on i.i.d. noise, DDPM at w_ind_noise 0.8."""
    js, ts = _pair("euler", {}, dict(s_churn=1.0))
    assert all(max(e) <= TOL for e in _chain(js, ts, noise_type="random"))
    js, ts = _pair("ddpm", {}, {})
    assert all(max(e) <= TOL for e in _chain(js, ts, w_ind_noise=0.8))


def test_dpm_state_threads_and_start_step_takes_second_order():
    """The multistep state carries the previous x0 across steps; a run that
    starts at step 1 takes a second-order step against the zero state, as
    the JAX package does (diffusers would take a first-order one)."""
    js, ts = _pair("dpmpp_2m", {}, {}, steps=4)
    assert all(max(e) <= TOL for e in _chain(js, ts))
    assert all(max(e) <= TOL for e in _chain(js, ts, start=1))

    rng = np.random.default_rng(2)
    x, out = (torch.from_numpy(rng.standard_normal(SHAPE, dtype=np.float32)) for _ in range(2))
    zero = ts.init_state(SHAPE)
    assert zero.dtype == torch.float32 and not zero.any()
    second, x0, state = ts.step(out, 1, x, zero)
    torch.testing.assert_close(state, x0, rtol=0, atol=0)
    # the first-order update from the same point differs: the zero state acted
    s0, s1 = float(ts.sigmas[1]), float(ts.sigmas[2])
    a1, st0, st1 = 1 / (s1**2 + 1) ** 0.5, s0 / (s0**2 + 1) ** 0.5, s1 / (s1**2 + 1) ** 0.5
    lam = lambda a, s: np.log(a / s)  # noqa: E731
    h = lam(a1, st1) - lam(1 / (s0**2 + 1) ** 0.5, st0)
    first = (st1 / st0) * x - a1 * np.expm1(-h) * x0
    assert (second - first).abs().max() > 1e-3


def test_factory_builds_six_families_and_refuses_unknown_names():
    names = ("euler", "euler_ancestral", "ddim", "ddpm", "lcm", "dpmpp_2m")
    for name in names:
        assert type(create_scheduler(name, 4)).__name__ == type(j_create(name, 4)).__name__
    with pytest.raises(ValueError) as got:
        create_scheduler("heun", 4)
    with pytest.raises(ValueError) as want:
        j_create("heun", 4)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="original_inference_steps"):
        create_scheduler("lcm", 51)


def test_stochastic_steps_draw_from_the_generator_only():
    """Without noise= a stochastic step needs a generator, and the same
    generator seed gives the same step; a deterministic step needs neither."""
    ts = create_scheduler("euler_ancestral", 3)
    x = torch.zeros(SHAPE)
    with pytest.raises(ValueError, match="Generator"):
        ts.step(x, 0, x)
    a, _ = ts.step(x, 0, x, generator=torch.Generator().manual_seed(3))
    b, _ = ts.step(x, 0, x, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.abs().max() > 0
    create_scheduler("euler", 3).step(x, 0, x)

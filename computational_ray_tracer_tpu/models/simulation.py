"""Stochastic and ODE simulation models.

Capability parity with the reference's simulation apps:

- ``MuscleCrossbridgeApp`` (Applications/MuscleCrossbridgeApp.h:86-330):
  n0 = 10000 crossbridges, Bernoulli attach (f = 14/s) / detach (g = 126/s)
  per step, spring-force accumulation Σ k·x(i), force-velocity sweep. Array-
  first: the whole bridge population is a vectorized state advanced by one
  ``lax.scan`` over time; the Bernoulli draws use the counter-based RNG so
  trajectories are reproducible.
- ``ODESolverApp`` (Applications/ODESolverApp.h:51-100): Euler's method,
  plus the RK2/RK4 integrators the reference planned in comments — all as
  ``lax.scan`` loops over vector states.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from computational_ray_tracer_tpu.ops import rng as crng


# ---------------------------------------------------------------------------
# ODE solvers (Euler / RK2 / RK4) via lax.scan
# ---------------------------------------------------------------------------

def _solve(f, y0, t0, dt, n_steps, step_fn):
    def body(carry, i):
        y, t = carry
        y_new = step_fn(f, y, t, dt)
        return (y_new, t + dt), y_new

    (_, _), ys = jax.lax.scan(body, (jnp.asarray(y0, jnp.float32),
                                     jnp.float32(t0)),
                              jnp.arange(n_steps))
    ts = t0 + dt * (1 + jnp.arange(n_steps, dtype=jnp.float32))
    return ts, ys


def _euler_step(f, y, t, dt):
    return y + dt * f(t, y)


def _rk2_step(f, y, t, dt):
    k1 = f(t, y)
    k2 = f(t + dt, y + dt * k1)
    return y + dt * 0.5 * (k1 + k2)


def _rk4_step(f, y, t, dt):
    k1 = f(t, y)
    k2 = f(t + dt / 2, y + dt / 2 * k1)
    k3 = f(t + dt / 2, y + dt / 2 * k2)
    k4 = f(t + dt, y + dt * k3)
    return y + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)


def euler(f, y0, t0, dt, n_steps):
    """Euler's method (ODESolverApp.h:51-100)."""
    return _solve(f, y0, t0, dt, n_steps, _euler_step)


def rk2(f, y0, t0, dt, n_steps):
    """Heun's RK2 (the reference's planned extension)."""
    return _solve(f, y0, t0, dt, n_steps, _rk2_step)


def rk4(f, y0, t0, dt, n_steps):
    """Classic RK4 (the reference's planned extension)."""
    return _solve(f, y0, t0, dt, n_steps, _rk4_step)


SOLVERS = {"euler": euler, "rk2": rk2, "rk4": rk4}


# ---------------------------------------------------------------------------
# Muscle crossbridge stochastic simulation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CrossbridgeConfig:
    """MuscleCrossbridgeApp parameters (:110-130)."""
    n_bridges: int = 10000
    attach_rate: float = 14.0     # f, 1/s
    detach_rate: float = 126.0    # g, 1/s
    dt: float = 1e-3              # s
    spring_k: float = 1.0         # pN/nm
    x_attach: float = 8.0         # nm: power-stroke attachment position
    seed: int = 0


@partial(jax.jit, static_argnames=("cfg", "n_steps"))
def simulate_crossbridges(cfg: CrossbridgeConfig, n_steps: int,
                          velocity=0.0):
    """Advance the bridge population n_steps; sliding `velocity` (nm/s)
    drags attached bridges' strain. Returns dict of per-step traces:
    n_attached, total_force, and final state.

    Per step (the reference's :86-105 loop, vectorized): each detached
    bridge attaches w.p. f·dt at x = x_attach; each attached bridge detaches
    w.p. g·dt; attached strains advance by -v·dt; force = Σ k·x."""
    n = cfg.n_bridges

    def body(carry, step):
        attached, x = carry
        u_att = crng.independent_1d(cfg.seed, jnp.arange(n), step, 0)
        u_det = crng.independent_1d(cfg.seed, jnp.arange(n), step, 1)
        attach_now = (~attached) & (u_att < cfg.attach_rate * cfg.dt)
        detach_now = attached & (u_det < cfg.detach_rate * cfg.dt)
        attached_new = (attached | attach_now) & ~detach_now
        x_new = jnp.where(attach_now, cfg.x_attach,
                          x - velocity * cfg.dt)
        x_new = jnp.where(attached_new, x_new, 0.0)
        force = jnp.sum(jnp.where(attached_new, cfg.spring_k * x_new, 0.0))
        return (attached_new, x_new), (jnp.sum(attached_new), force)

    init = (jnp.zeros(n, bool), jnp.zeros(n))
    (attached, x), (n_att, force) = jax.lax.scan(
        body, init, jnp.arange(n_steps, dtype=jnp.uint32))
    return {"n_attached": n_att, "force": force,
            "final_attached": attached, "final_x": x}


def steady_state_attachment_fraction(cfg: CrossbridgeConfig):
    """Analytic steady state of the two-state model: f / (f + g)."""
    return cfg.attach_rate / (cfg.attach_rate + cfg.detach_rate)


def force_velocity_curve(cfg: CrossbridgeConfig, velocities, n_steps=2000,
                         n_average=500):
    """Mean steady-state force at each sliding velocity (the app's
    force-velocity plot capability)."""
    out = []
    for v in velocities:
        res = simulate_crossbridges(cfg, n_steps, float(v))
        out.append(float(jnp.mean(res["force"][-n_average:])))
    return np.asarray(out)

"""Differentiable inverse rendering (BASELINE config 5).

The reference is a forward renderer only; differentiability is this
framework's JAX-native extension (BASELINE.json north star): pixel radiance
is differentiable w.r.t. material / light parameters through the wavefront
integrators, with *detached sampling* — every discrete/sampling decision
(wavelengths, lens/filter offsets, BSDF directions, RR, light picks, hit
IDs) is computed under ``stop_gradient``, while the radiance evaluated at
those samples carries gradients. Visibility/silhouette gradients are out of
scope (SURVEY §7 hard parts).

Provides parameter-pytree plumbing (extract/insert on a Scene), a jitted
loss/grad, a plain Adam loop, and finite-difference validation utilities
used by the gradient allclose tests.
"""

from __future__ import annotations

import dataclasses as dc
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from computational_ray_tracer_tpu.models import integrator as integ
from computational_ray_tracer_tpu.ops import film as filmmod


def albedo_params(scene):
    """(extract, insert) for material albedo coefficients."""
    def extract(s):
        return {"albedo_coeffs": s.materials.albedo_coeffs}

    def insert(s, p):
        return dc.replace(s, materials=dc.replace(
            s.materials, albedo_coeffs=p["albedo_coeffs"]))
    return extract, insert


def albedo_and_emission_params(scene):
    """(extract, insert) for albedo + light emission scales (the Cornell
    recovery task of BASELINE config 5)."""
    def extract(s):
        return {"albedo_coeffs": s.materials.albedo_coeffs,
                "light_scale": s.lights.scale,
                "emission": s.materials.emission}

    def insert(s, p):
        mats = dc.replace(s.materials, albedo_coeffs=p["albedo_coeffs"],
                          emission=p["emission"])
        lts = dc.replace(s.lights, scale=p["light_scale"])
        return dc.replace(s, materials=mats, lights=lts)
    return extract, insert


def make_render_fn(camera, cfg: integ.RenderConfig, spp=None):
    """A differentiable deterministic render: fixed sample indices, mean
    sensor-RGB image (no film state) — the function whose Jacobian we test."""
    filter_obj = integ.make_filter(cfg)
    sensor = integ.make_sensor(cfg)
    n_spp = spp if spp is not None else cfg.sampler.spp

    def render_image(scene):
        w, h = cfg.resolution
        total = jnp.zeros((h, w, 3))
        wsum = jnp.zeros((h, w))
        for i in range(n_spp):
            rgb, wt = integ.render_pass(scene, camera, cfg, filter_obj,
                                        sensor, jnp.uint32(i))
            total = total + rgb * wt[..., None]
            wsum = wsum + wt
        return total / jnp.maximum(wsum[..., None], 1e-12)

    return render_image, sensor


def make_loss_fn(camera, cfg, extract_insert, target):
    extract, insert = extract_insert
    render_image, _ = make_render_fn(camera, cfg)

    def loss(params, scene):
        img = render_image(insert(scene, params))
        return jnp.mean((img - target) ** 2)

    return loss


def optimize(scene, camera, cfg, extract_insert, target, steps=50, lr=2e-2,
             callback=None):
    """Adam descent on scene parameters against a target image."""
    import optax
    extract, insert = extract_insert
    loss_fn = make_loss_fn(camera, cfg, extract_insert, target)
    opt = optax.adam(lr)
    params = extract(scene)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, scene):
        l, g = jax.value_and_grad(loss_fn)(params, scene)
        updates, opt_state = opt.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, l

    history = []
    for i in range(steps):
        params, opt_state, l = step(params, opt_state, scene)
        history.append(float(l))
        if callback:
            callback(i, params, float(l))
    return insert(scene, params), params, history


def finite_difference_grad(f, params, eps=1e-3):
    """Central finite differences of a scalar function over a pytree —
    the reference oracle for gradient allclose tests."""
    flat, tree = jax.tree_util.tree_flatten(params)
    grads = []
    for k, leaf in enumerate(flat):
        leaf = np.asarray(leaf, np.float64)
        g = np.zeros_like(leaf)
        it = np.nditer(leaf, flags=["multi_index"])
        for _ in it:
            idx = it.multi_index
            lp = leaf.copy()
            lm = leaf.copy()
            lp[idx] += eps
            lm[idx] -= eps
            fp = float(f(jax.tree_util.tree_unflatten(
                tree, flat[:k] + [jnp.asarray(lp, jnp.float32)] + flat[k+1:])))
            fm = float(f(jax.tree_util.tree_unflatten(
                tree, flat[:k] + [jnp.asarray(lm, jnp.float32)] + flat[k+1:])))
            g[idx] = (fp - fm) / (2 * eps)
        grads.append(jnp.asarray(g, jnp.float32))
    return jax.tree_util.tree_unflatten(tree, grads)

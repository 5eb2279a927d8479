"""Multi-chip rendering and training via jax.sharding + shard_map.

The reference's only parallelism is a shared-memory CPU thread pool with a
static pixel-range split and fork-join per sample pass
(``RayTracerTestApp.h:349-409``; SURVEY §2.6). The JAX-native equivalent:

- a ``Mesh`` over the devices with two logical axes: ``dp`` (pixels —
  the data-parallel axis, the analog of the reference's pixel ranges) and
  ``sp`` (samples per pixel — the sample/"sequence" axis);
- the scene (shape tables, octree, materials, lights) is *replicated*; the
  pixel wavefront is sharded over ``dp`` and sample indices over ``sp``;
- film accumulation is associative, so per-device partial films merge with a
  single ``psum`` over ``sp`` (pixels stay owner-sharded over ``dp`` — no
  communication needed there);
- inverse-rendering gradients are ``psum``-ed over BOTH axes — the
  all-reduce XLA overlaps with the backward pass;
- determinism is placement-invariant because every sample is a pure function
  of (pixel, sample, dim, seed) (SURVEY §3.4) — resharding cannot change the
  image.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from computational_ray_tracer_tpu.ops import spectrum as spec
from computational_ray_tracer_tpu.ops import film as filmmod
from computational_ray_tracer_tpu.models import integrator as integ


def make_mesh(n_dp=None, n_sp=1, devices=None):
    """Build a (dp, sp) device mesh. Defaults to all devices on dp."""
    devices = devices if devices is not None else jax.devices()
    n_dp = n_dp if n_dp is not None else len(devices) // n_sp
    if n_dp * n_sp > len(devices):
        raise ValueError(
            f"mesh needs {n_dp}x{n_sp}={n_dp * n_sp} devices but only "
            f"{len(devices)} available ({devices[0].platform}); pass "
            f"devices=jax.devices('cpu') for a virtual CPU mesh")
    dev = np.asarray(devices[: n_dp * n_sp]).reshape(n_dp, n_sp)
    return Mesh(dev, axis_names=("dp", "sp"))


def _pass_for_pixels(scene, camera, cfg, filter_obj, sensor, pixel,
                     sample_idx):
    """render one sample for an arbitrary flat pixel-id array (the sharded
    inner body; mirrors integrator.render_pass but over a pixel slice)."""
    w, h = cfg.resolution
    s = cfg.sampler
    px = (pixel % w).astype(jnp.float32)
    py = (pixel // w).astype(jnp.float32)
    u_lam = s.get_1d(pixel, sample_idx, integ.DIM_LAMBDA)
    wl = integ._sample_wavelengths(cfg, u_lam)
    u_filt = s.get_2d(pixel, sample_idx, integ.DIM_FILTER)
    fp, fw = filter_obj.sample(u_filt)
    pixel_pos = jnp.stack([px + 0.5, py + 0.5], axis=-1) + fp
    u_lens = s.get_2d(pixel, sample_idx, integ.DIM_LENS)
    o, d = camera.generate_rays(pixel_pos, u_lens)
    if cfg.integrator == "direct":
        L = integ.li_direct(scene, o, d, wl, pixel, sample_idx, cfg)
        wl_out = wl
    elif cfg.integrator == "walk":
        L, wl_out = integ.li_random_walk(scene, o, d, wl, pixel, sample_idx,
                                         cfg)
    elif cfg.integrator == "simple":
        # Must match render_pass's dispatch exactly: substituting MIS here
        # would change sample values sharded-vs-single for "simple" configs,
        # breaking the determinism contract.
        L, wl_out = integ.li_simple_path(scene, o, d, wl, pixel, sample_idx,
                                         cfg)
    else:
        L, wl_out = integ.li_path(scene, o, d, wl, pixel, sample_idx, cfg)
    rgb = jnp.maximum(sensor.to_sensor_rgb(L, wl_out), 0.0)
    if cfg.clamp > 0.0:
        rgb = jnp.minimum(rgb, cfg.clamp)
    return rgb, fw


def make_sharded_render(scene_template, camera, cfg, mesh: Mesh):
    """Compile a sharded progressive render step.

    Returns ``step(scene, film, base_sample_idx) -> film`` where each call
    accumulates ``n_sp`` sample passes (one per sp-shard) with pixels split
    over dp. Works on any (dp, sp) mesh, including a CPU device mesh.
    """
    filter_obj = integ.make_filter(cfg)
    sensor = integ.make_sensor(cfg)
    w, h = cfg.resolution
    n_pix = w * h
    n_sp = mesh.shape["sp"]

    def body(scene, rgb_sum, wt_sum, pixel, base_idx):
        # pixel: local (n_pix/dp,) shard; runs one pass per local sp index
        sp_idx = jax.lax.axis_index("sp").astype(jnp.uint32)
        sample_idx = base_idx + sp_idx
        rgb, fw = _pass_for_pixels(scene, camera, cfg, filter_obj, sensor,
                                   pixel, sample_idx)
        rgb_add = jax.lax.psum(rgb * fw[..., None], "sp")
        wt_add = jax.lax.psum(fw, "sp")
        return rgb_sum + rgb_add, wt_sum + wt_add

    sharded = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P("dp", None), P("dp"), P("dp"), P()),
        out_specs=(P("dp", None), P("dp")),
        check_vma=False)

    @jax.jit
    def step(scene, film: filmmod.Film, base_sample_idx):
        pixel = jnp.arange(n_pix, dtype=jnp.uint32)
        rgb_flat = film.rgb_sum.reshape(n_pix, 3)
        wt_flat = film.weight_sum.reshape(n_pix)
        rgb_new, wt_new = sharded(scene, rgb_flat, wt_flat, pixel,
                                  jnp.uint32(base_sample_idx))
        return filmmod.Film(rgb_new.reshape(h, w, 3), wt_new.reshape(h, w),
                            film.spp_done + n_sp)

    return step, sensor


def render_distributed(scene, camera, cfg, mesh=None):
    """Full sharded render: spp passes in groups of n_sp."""
    mesh = mesh or make_mesh()
    step, sensor = make_sharded_render(scene, camera, cfg, mesh)
    film = filmmod.Film.create(cfg.resolution)
    n_sp = mesh.shape["sp"]
    for base in range(0, cfg.sampler.spp, n_sp):
        film = step(scene, film, base)
    return film, sensor


# ---------------------------------------------------------------------------
# Distributed inverse-rendering training step (BASELINE config 5)
# ---------------------------------------------------------------------------

def make_train_step(scene_template, camera, cfg, mesh: Mesh, param_labels,
                    optimizer=None):
    """Sharded gradient-descent step on scene parameters against a target
    image: pixels over dp, sample passes over sp, grads psum over both.

    ``param_labels``: function scene -> pytree of differentiable leaves
    (e.g. albedo coefficients, light scales) and its inverse merge. We use
    (extract, insert) functions for clarity.
    """
    import optax
    extract, insert = param_labels
    opt = optimizer or optax.adam(2e-2)
    filter_obj = integ.make_filter(cfg)
    sensor = integ.make_sensor(cfg)
    w, h = cfg.resolution
    n_pix = w * h

    def loss_body(params, scene, target_flat, pixel, sample_idx):
        scene = insert(scene, params)
        sp_idx = jax.lax.axis_index("sp").astype(jnp.uint32)
        rgb, fw = _pass_for_pixels(scene, camera, cfg, filter_obj, sensor,
                                   pixel, sample_idx + sp_idx)
        # filter-weighted average over the sp passes — identical estimator
        # to the single-device Film resolve (rgb_sum / weight_sum)
        rgb_sum = jax.lax.psum(rgb * fw[..., None], "sp")
        wt_sum = jax.lax.psum(fw, "sp")
        rgb = rgb_sum / jnp.maximum(wt_sum[..., None], 1e-12)
        err = (rgb - target_flat) ** 2
        # mean over the local pixel shard, then over dp
        return jax.lax.pmean(jnp.mean(err), "dp")

    def grad_body(params, scene, target_flat, pixel, sample_idx):
        l, g = jax.value_and_grad(loss_body)(params, scene, target_flat,
                                             pixel, sample_idx)
        # loss/grad already pmean'ed over dp inside; psum grads over sp
        g = jax.lax.pmean(g, "sp")
        g = jax.lax.pmean(g, "dp")
        return l, g

    sharded_grad = jax.shard_map(
        grad_body, mesh=mesh,
        in_specs=(P(), P(), P("dp", None), P("dp"), P()),
        out_specs=(P(), P()),
        check_vma=False)

    @jax.jit
    def train_step(params, opt_state, scene, target, sample_idx):
        target_flat = target.reshape(n_pix, 3)
        pixel = jnp.arange(n_pix, dtype=jnp.uint32)
        loss, grads = sharded_grad(params, scene, target_flat, pixel,
                                   jnp.uint32(sample_idx))
        updates, opt_state = opt.update(grads, opt_state, params)
        import optax as _ox
        params = _ox.apply_updates(params, updates)
        return params, opt_state, loss

    def init(params):
        return opt.init(params)

    return train_step, init, sensor


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Multi-host bring-up (SURVEY §5 distributed-communication plan):
    ``jax.distributed.initialize`` per host, then a global mesh over every
    device. Collectives (psum of film / gradients) take the fastest link
    XLA finds between the devices (NVLink within a host, the network
    across hosts). No-op on a single process.

    Returns (n_processes, global_device_count)."""
    import jax

    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    return jax.process_count(), len(jax.devices())


def global_mesh(n_sp=1):
    """Mesh spanning every addressable chip across all hosts:
    ('dp', 'sp') with dp = total_devices / n_sp. Host boundaries fall on
    the dp axis so the sp (sample-pass) collectives stay within a host."""
    import jax

    devs = jax.devices()
    n = len(devs)
    assert n % n_sp == 0, f"{n} devices not divisible by sp={n_sp}"
    return make_mesh(n_dp=n // n_sp, n_sp=n_sp, devices=devs)

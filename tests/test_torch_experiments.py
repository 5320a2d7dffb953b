"""The port's experiment drivers (``mrijax_torch.train.experiments``) against
``mrijax``'s on the CPU: ``run_experiment`` of both packages on the same
synthetic BraTS tree at tiny widths, the JAX package on a one-device CPU
mesh, the port with ``device="cpu"``.

The two frameworks draw different timesteps and noise, so losses are not
compared. What is compared:

* every batch each train and eval step received, in the same order (the
  step factories of both packages are wrapped in the test): bitwise, but for
  the cached latents, which each package's encoder wrote (``LATENT_ATOL``);
* the number of train and val steps of each stage and the run directory;
* with ``learning_rate`` 0 in both stages, so that the VAE stays at its
  converted init: the latent cache to 1e-4 absolute (``LATENT_ATOL``, two
  float32 convolution stacks) with the same ``index.json``, and the latent
  scale to 1e-5 relative (``SCALE_RTOL``);
* the drivers' own checks, raised in the same order.

Parameters are carried across: the JAX package's ``_init_params`` is
swapped for seeded parameters of the shapes its init makes, and the port's
for one that loads them through ``*_state_dict_from_flax``. This file holds the 3D
family with ``cache_latents`` and the helpers; the per-step-encode route and
the 2D / 2.5D families are in the two ``test_torch_experiments_*`` files.
"""

import json
from collections.abc import Mapping

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_threads import thread_budget  # noqa: F401  (autouse)
from mrijax import config as jconfig
from mrijax.io import CheckpointManager as JCheckpointManager
from mrijax.obs import MetricsLogger as JMetricsLogger
from mrijax.parallel import global_put, make_mesh, replicated_sharding
from mrijax.train import experiments as jexp
from mrijax_torch import config
from mrijax_torch.data import packing, synthetic
from mrijax_torch.io import (
    unet2d_state_dict_from_flax,
    unet3d_state_dict_from_flax,
    vae3d_state_dict_from_flax,
)
from mrijax_torch.io.checkpoint import CheckpointManager
from mrijax_torch.obs import MetricsLogger, reset_termination
from mrijax_torch.train import experiments

LATENT_ATOL = 1e-4
SCALE_RTOL = 1e-5
FINGERPRINT_RTOL = 1e-6

STEP_FACTORIES = (
    "make_vae_train_step", "make_vae_eval_step",
    "make_cached_latent_train_step", "make_cached_latent_eval_step",
    "make_latent_diffusion_train_step", "make_latent_diffusion_eval_step",
    "make_diffusion_train_step", "make_diffusion_eval_step",
)
BATCH_KEYS = {"image", "volume", "latent"}

TINY_3D = {
    "data.batch_size": 1, "data.latent_batch_size": 2, "data.patch_size": (8, 16, 16),
    "data.val_fraction": 0.34,
    "vae.base_channels": 8, "vae.num_down": 2, "vae.latent_channels": 4,
    "vae.compute_dtype": "float32", "vae.remat": False,
    "unet.in_channels": 4, "unet.out_channels": 4, "unet.base_channels": 8,
    "unet.channel_mults": (1, 2), "unet.time_emb_dim": 16, "unet.num_heads": 2,
    "unet.compute_dtype": "float32",
    "diffusion.timesteps": 10,
    "train.epochs": 1, "train.learning_rate": 0.0, "train.debug_fast": True,
    "train.debug_max_steps": 2, "train.ema_decay": 0.999,
    "vae_train.epochs": 1, "vae_train.learning_rate": 0.0, "vae_train.debug_fast": True,
    "vae_train.debug_max_steps": 2,
}


@pytest.fixture(scope="module")
def brats_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("brats")
    synthetic.write_synthetic_brats(root, num_subjects=6, shape=(32, 32, 20), seed=0)
    return root


def _host(batch):
    return {k: np.array(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in batch.items()}


def record_steps(monkeypatch, module, log):
    """Wrap every step factory of a drivers module: each step the factory
    makes appends (factory name, the batch it received, on the host)."""
    for name in STEP_FACTORIES:
        factory = getattr(module, name)

        def make(*args, _factory=factory, _name=name, **kwargs):
            step = _factory(*args, **kwargs)

            def recorded(*a, **kw):
                batch = next(x for x in a if isinstance(x, Mapping) and x.keys() & BATCH_KEYS)
                log.append((_name, _host(batch)))
                return step(*a, **kw)

            return recorded

        monkeypatch.setattr(module, name, make)


def carry_jax_init(monkeypatch):
    """Give the JAX package's models seeded parameters of the shapes its init
    makes (``jax.eval_shape`` of the init: a trace, no compile) and keep them
    per model class; return the port's ``_init_params`` replacement that loads
    them, converted, into the model ``build`` makes."""
    inits = {}

    def jax_init(model, *args, seed=0, mesh=None):
        tree = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(seed), *args))
        rng = np.random.default_rng(seed)
        params = jax.tree_util.tree_map(
            lambda leaf: (0.1 * rng.normal(size=leaf.shape)).astype(np.float32), tree)
        inits[type(model).__name__] = (model, params)
        return global_put(jax.tree_util.tree_map(jnp.asarray, params),
                          replicated_sharding(mesh))

    monkeypatch.setattr(jexp, "_init_params", jax_init)

    def port_init(build, seed):
        model = build()
        jmodel, params = inits[type(model).__name__]
        name = type(model).__name__
        if name == "VAE3D":
            sd = vae3d_state_dict_from_flax(params, jmodel.num_down)
        elif name == "UNet3D":
            sd = unet3d_state_dict_from_flax(params, jmodel.channel_mults, jmodel.use_attention,
                                             jmodel.attention_levels)
        else:
            sd = unet2d_state_dict_from_flax(params, channel_mults=jmodel.channel_mults)
        model.load_state_dict(sd, strict=True)
        return model

    return port_init


def run_both(monkeypatch, tmp_path, family, root, overrides, *, packed_dir=None):
    """``run_experiment`` of the JAX package, then of the port, on the same
    config; returns the results, the recorded steps and the two run dirs."""
    reset_termination()
    preset = {"slice_cond_2d": "preset_slice_cond_2d", "ddpm_25d": "preset_ddpm_25d",
              "ddpm_3d_ldm": "preset_ddpm_3d_ldm"}[family]
    over = {**overrides, "name": "t"}
    if packed_dir is not None:
        over["data.packed_dir"] = str(packed_dir)
    port_init = carry_jax_init(monkeypatch)
    logs = {"jax": [], "port": []}
    record_steps(monkeypatch, jexp, logs["jax"])
    record_steps(monkeypatch, experiments, logs["port"])
    results, dirs = {}, {}
    for pkg in ("jax", "port"):
        ckpt = tmp_path / pkg / "ckpt"
        cfg_over = {**over, "train.checkpoint_dir": str(ckpt),
                    "vae_train.checkpoint_dir": str(ckpt)}
        if pkg == "jax":
            cfg = getattr(jconfig, preset)(str(root), **cfg_over)
            mesh = make_mesh(("data",), devices=jax.devices()[:1])
            logger = JMetricsLogger(family, run_name="t", root=str(tmp_path / pkg / "runs"))
            results[pkg] = jexp.run_experiment(cfg, mesh=mesh, logger=logger)
        else:
            monkeypatch.setattr(experiments, "_init_params", port_init)
            cfg = getattr(config, preset)(str(root), **cfg_over)
            logger = MetricsLogger(family, run_name="t", root=str(tmp_path / pkg / "runs"))
            results[pkg] = experiments.run_experiment(cfg, device="cpu", logger=logger)
        logger.finish()
        dirs[pkg] = ckpt / family / "t"
    return results, logs, dirs


def assert_same_batches(logs):
    """The same steps in the same order, each with the same batch: bitwise,
    except the cached latents, which each package's own encoder wrote (the
    same crops of caches that agree to ``LATENT_ATOL``)."""
    got, want = logs["port"], logs["jax"]
    assert [name for name, _ in got] == [name for name, _ in want]
    for (name, g), (_, w) in zip(got, want):
        assert g.keys() == w.keys(), name
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, (name, k)
            if k == "latent":
                np.testing.assert_allclose(g[k], w[k], atol=LATENT_ATOL, rtol=0,
                                           err_msg=f"{name} {k}")
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{name} {k}")


def run_layout(run_dir):
    """The entries of a run directory; a step checkpoint counts by its step
    (a ``.pt`` file in the port, a directory of the JAX package's)."""
    return sorted(p.name.removesuffix(".pt") for p in run_dir.iterdir())


def step_counts(logs):
    return {name: sum(n == name for n, _ in logs) for name in dict(logs)}


def latest_steps(run_dir, stages):
    """Latest checkpoint step of each stage, as each package's manager reads
    its own tree."""
    out = {}
    for pkg, manager in (("jax", JCheckpointManager), ("port", CheckpointManager)):
        out[pkg] = {}
        for stage in stages:
            m = manager(run_dir[pkg] / stage if stage else run_dir[pkg])
            out[pkg][stage] = m.latest_step
            if pkg == "jax":
                m.close()
    return out


def assert_same_latent_caches(dirs):
    caches = {pkg: d / "latent_cache" for pkg, d in dirs.items()}
    index = {pkg: json.loads((c / "index.json").read_text()) for pkg, c in caches.items()}
    fp = {pkg: i.pop("params_fingerprint") for pkg, i in index.items()}
    assert fp["port"] == pytest.approx(fp["jax"], rel=FINGERPRINT_RTOL)
    assert index["port"] == index["jax"]
    for f in index["jax"]["files"]:
        got = np.load(caches["port"] / f["path"])["latent"]
        want = np.load(caches["jax"] / f["path"])["latent"]
        np.testing.assert_allclose(got, want, atol=LATENT_ATOL, rtol=0)


def assert_3d_run(results, logs, dirs, stage2_counts):
    """What both 3D routes check: batches, step counts (4 train and 2 val
    subjects; stage 1 at batch 1, capped at 2 steps), layout, scale."""
    assert_same_batches(logs)
    counts = step_counts(logs["port"])
    assert counts == {"make_vae_train_step": 2, "make_vae_eval_step": 2, **stage2_counts}
    assert step_counts(logs["jax"]) == counts
    assert run_layout(dirs["port"]) == run_layout(dirs["jax"])
    steps = latest_steps(dirs, ("vae", "ldm"))
    assert steps["port"] == steps["jax"] == {"vae": 2, "ldm": 2}
    (jv, jl, jscale), (pv, pl, pscale) = results["jax"], results["port"]
    assert pscale == pytest.approx(jscale, rel=SCALE_RTOL)
    assert (pv.epochs_run, pl.epochs_run) == (jv.epochs_run, jl.epochs_run) == (1, 1)
    assert np.isfinite(pv.best_val_loss) and np.isfinite(pl.best_val_loss)
    payload = torch.load(dirs["port"] / "ldm" / "2.pt", weights_only=False)
    assert payload["extra"]["latent_scale"] == pytest.approx(pscale, rel=1e-12)


def test_3d_cached_route_matches_jax_and_resumes(monkeypatch, tmp_path, brats_root):
    """``cache_latents`` from ``pack_volumes`` shards; then the port's run
    again on the same directory: both stages resume at their end, the cache
    is judged fresh and not repacked, and no step runs."""
    packed = tmp_path / "packed"
    packing.pack_volumes(brats_root, packed)
    results, logs, dirs = run_both(monkeypatch, tmp_path, "ddpm_3d_ldm", brats_root,
                                   {**TINY_3D, "train.cache_latents": True}, packed_dir=packed)
    # stage 2 at batch 2 from latent crops; validation takes full batches only
    assert_3d_run(results, logs, dirs, {"make_cached_latent_train_step": 2,
                                        "make_cached_latent_eval_step": 1})
    assert logs["port"][-2][1]["latent"].shape == (2, 4, 8, 8, 4)
    assert_same_latent_caches(dirs)

    # the same call again, port only: everything resumes, nothing is packed
    index = dirs["port"] / "latent_cache" / "index.json"
    before = index.stat().st_mtime_ns
    packs = []
    monkeypatch.setattr(experiments, "pack_latents",
                        lambda *a, **kw: packs.append(a) or packing.pack_latents(*a, **kw))
    logs["port"].clear()
    cfg = config.preset_ddpm_3d_ldm(str(brats_root), **{
        **TINY_3D, "name": "t", "train.cache_latents": True, "data.packed_dir": str(packed),
        "train.checkpoint_dir": str(tmp_path / "port" / "ckpt")})
    vae_res, ldm_res, scale = experiments.run_experiment(
        cfg, device="cpu", logger=MetricsLogger("r", root=str(tmp_path / "runs2")))
    assert logs["port"] == [] and packs == []
    assert index.stat().st_mtime_ns == before
    assert (vae_res.epochs_run, ldm_res.epochs_run) == (0, 0)
    assert scale == pytest.approx(results["port"][2], rel=1e-12)


# ------------------------------------------------------------ driver checks


def _both_raise(monkeypatch, tmp_path, brats_root, overrides, match):
    """Both packages raise ``match`` before stage 1 trains anything."""
    logs = {"jax": [], "port": []}
    record_steps(monkeypatch, jexp, logs["jax"])
    record_steps(monkeypatch, experiments, logs["port"])
    over = {**TINY_3D, **overrides, "name": "bad",
            "train.checkpoint_dir": str(tmp_path / "ckpt")}
    mesh = make_mesh(("data",), devices=jax.devices()[:1])
    with pytest.raises(ValueError, match=match):
        jexp.run_experiment(jconfig.preset_ddpm_3d_ldm(str(brats_root), **over), mesh=mesh,
                            logger=JMetricsLogger("bad", root=str(tmp_path / "jruns")))
    with pytest.raises(ValueError, match=match):
        experiments.run_experiment(config.preset_ddpm_3d_ldm(str(brats_root), **over),
                                   device="cpu",
                                   logger=MetricsLogger("bad", root=str(tmp_path / "runs")))
    assert logs == {"jax": [], "port": []}
    assert not (tmp_path / "ckpt" / "ddpm_3d_ldm" / "bad" / "vae").exists()


@pytest.mark.parametrize("overrides, match", [
    ({"unet.remat_levels": (0, 5)}, "out of range"),
    ({"train.cache_latents": True, "data.patch_size": (9, 16, 16)}, "divisible"),
    # both wrong: the UNet config is checked first, in both packages
    ({"unet.remat_levels": (0, 5), "train.cache_latents": True,
      "data.patch_size": (9, 16, 16)}, "out of range"),
], ids=["unet", "patch", "unet_before_patch"])
def test_driver_checks_raise_in_the_same_order(monkeypatch, tmp_path, brats_root, overrides,
                                               match):
    _both_raise(monkeypatch, tmp_path, brats_root, overrides, match)


def test_drivers_refuse_what_needs_more_than_one_device(monkeypatch, tmp_path, brats_root):
    assert not torch.cuda.is_available()
    cfg = config.preset_slice_cond_2d(str(brats_root), **{
        "data.image_size": 16, "train.checkpoint_dir": str(tmp_path / "ckpt")})
    logger = MetricsLogger("x", root=str(tmp_path / "runs"))
    with pytest.raises(RuntimeError, match="cuda"):
        experiments.run_experiment(cfg, logger=logger)
    # num_devices must be the data axis' size: one process is an axis of 1
    cfg.train.num_devices = 2
    with pytest.raises(ValueError, match="num_devices=2"):
        experiments.run_experiment(cfg, device="cpu", logger=logger)
    cfg.train.num_devices = None
    cfg.vae_train.num_devices = 4
    with pytest.raises(ValueError, match="vae_train.num_devices=4"):
        experiments.run_experiment(cfg, device="cpu", logger=logger)
    cfg.vae_train.num_devices = None
    cfg.family = "nope"
    with pytest.raises(ValueError, match="unknown family"):
        experiments.run_experiment(cfg, device="cpu", logger=logger)
    assert not (tmp_path / "ckpt").exists()


def test_init_params_is_seeded_and_leaves_the_rng_alone():
    cfg = config.preset_ddpm_3d_ldm(**TINY_3D)
    torch.manual_seed(123)
    state = torch.random.get_rng_state()
    a = experiments._init_params(lambda: experiments.build_vae3d(cfg.vae), 0)
    b = experiments._init_params(lambda: experiments.build_vae3d(cfg.vae), 0)
    c = experiments._init_params(lambda: experiments.build_vae3d(cfg.vae), 1)
    assert torch.equal(torch.random.get_rng_state(), state)
    for (name, p), q, r in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(p, q), name
    assert any(not torch.equal(p, r) for p, r in zip(a.parameters(), c.parameters()))
    assert {p.dtype for p in a.parameters()} == {torch.float32}

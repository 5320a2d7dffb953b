"""Training: train state, the optimizer-step factories of all three
families, plateau LR and early stopping, the epoch loop (``Trainer``), the
config builders and the experiment drivers (``run_experiment``).
Counterpart of ``mrijax/train`` (``state``, ``steps``, ``trainer`` and
``experiments``)."""

from mrijax_torch.train.state import (
    EarlyStopper,
    PlateauScheduler,
    TrainState,
    create_train_state,
    ema_update,
    get_learning_rate,
    inference_params,
    set_learning_rate,
)
from mrijax_torch.train.steps import (
    CFG_NULL_Z,
    apply_if_finite,
    estimate_latent_scale,
    estimate_latent_scale_from_latents,
    fixed_validation_timesteps,
    make_cached_latent_eval_step,
    make_cached_latent_train_step,
    make_diffusion_eval_step,
    make_diffusion_train_step,
    make_latent_diffusion_eval_step,
    make_latent_diffusion_train_step,
    make_vae_eval_step,
    make_vae_train_step,
    sample_timesteps,
    vae_loss,
)
from mrijax_torch.train.trainer import Trainer, TrainerResult
from mrijax_torch.train.experiments import (
    run_experiment,
    train_ddpm_25d,
    train_ddpm_3d_ldm,
    train_slice_cond_2d,
)

"""Flag-compatible entry point (PyTorch port of
`nerf_from_image_tpu/cli/run.py`, the reference's run.py).

    python -m nerf_from_image_tpu_torch.cli.run --dataset p3d_car \\
        --run_inversion --resume_from <gan.pth> --coord_resume_from <enc.pth>

`main` parses the JAX CLI's flags (`config.py`), loads the dataset
(`data/loaders.py`), builds the generator of `GANConfig` and restores the
EMA weights from --resume_from (`utils/checkpoint.py`: `name`,
`name+iter` or a literal `.pth`, all in the reference's layout), then runs
the --run_inversion workload (`cli/inversion.py`). It runs on the card
(`main(argv, device='cpu')` on the CPU, as the tests call it).
--compute_dtype sets the generator's activations, bfloat16 by default;
the JAX CLI's inversion renders in float32 whatever the flag, so at the
default flags the two reports differ in precision (ROADMAP C). On the
card the generator must be bfloat16, since the kernels take bfloat16
planes: float32 there is refused before any work.

Not ported yet, and refused with NotImplementedError before any work,
each naming its item of ROADMAP queue A: GAN training and its SDF
pretraining, the demo (--inv_export_demo_sample,
--inv_manual_input_path), more than one device, the other datasets'
generator features (StyleGAN noise, orthographic cameras, view
directions) and GAN training's flag-only modes (encoder or class
conditioning, attention_values 0, --perturb_poses).
"""

from __future__ import annotations

import os

import torch

from nerf_from_image_tpu_torch import config as config_lib
from nerf_from_image_tpu_torch.data import loaders
from nerf_from_image_tpu_torch.device import DeviceLike, resolve_device
from nerf_from_image_tpu_torch.train import gan as gan_lib
from nerf_from_image_tpu_torch.utils import checkpoint as ckpt_lib
from nerf_from_image_tpu_torch.utils import convert


FEATURES = "the other datasets' generator features"
FLAG_MODES = "GAN training's flag-only modes"


def check_ported(args, dataset_config: dict) -> None:
    """Raises NotImplementedError, naming the ROADMAP item, for every
    branch and feature a later slice ports (`args` after the dataset's
    overrides)."""
    def refuse(what, item):
        raise NotImplementedError(f'{what} is not ported yet (ROADMAP '
                                  f'queue A: {item})')

    config_lib.check_single_device(args)
    if args.inv_export_demo_sample or args.inv_manual_input_path:
        refuse('the demo (--inv_export_demo_sample, '
               '--inv_manual_input_path)', 'the demo')
    if not args.run_inversion:
        refuse('GAN training and its SDF pretraining', 'the GAN-training CLI')
    if args.perturb_poses > 0:
        refuse('--perturb_poses', FLAG_MODES)
    if args.use_encoder or args.use_class:
        refuse('encoder or class conditioning', FLAG_MODES)
    if args.attention_values <= 0:
        refuse('attention_values 0', FLAG_MODES)
    if args.use_viewdir:
        refuse('view-direction conditioning (carla)', FEATURES)
    if not args.disable_stylegan_noise:
        refuse('StyleGAN noise injection', FEATURES)
    if dataset_config['camera_projection_model'] == 'ortho':
        refuse('orthographic cameras (cub)', FEATURES)


def make_gan_config(args, dataset_config: dict) -> gan_lib.GANConfig:
    return gan_lib.GANConfig(
        resolution=args.resolution, latent_dim=args.latent_dim,
        depth_samples_per_ray=config_lib.depth_samples(args),
        scene_range=dataset_config['scene_range'],
        white_background=dataset_config['white_background'],
        camera_flipped=dataset_config['camera_flipped'],
        supervise_alpha=args.supervise_alpha,
        attention_values=args.attention_values,
        is_highres=dataset_config.get('is_highres', False),
        r1=args.r1, tv=args.tv, entropy=args.entropy, eikonal=args.eikonal,
        augment_ada=args.augment_ada, augment_p_max=args.augment_p,
        clip_gradient_norm=args.clip_gradient_norm, lr_g=args.lr_g,
        lr_d=args.lr_d, batch_size=args.batch_size,
        plane_resolution=args.plane_resolution,
        path_length_regularization=args.path_length_regularization,
        dual_discriminator=args.dual_discriminator,
        use_encoder=args.use_encoder, use_class=args.use_class)


def main(argv=None, device: DeviceLike = None):
    """Runs the CLI on `device` (None: the card, raising without CUDA).
    Returns what `cli.inversion.run_inversion_cli` returns."""
    args = config_lib.parse_args(argv)
    if args.inv_manual_input_path:
        args.inv_export_demo_sample = True
    if args.inv_export_demo_sample:
        args.run_inversion = True
    if args.dataset == 'autodetect':
        assert args.resume_from, '--dataset autodetect needs --resume_from'
        args.dataset = config_lib.autodetect_dataset(args.resume_from)
    # The name is taken before the dataset's overrides, as the JAX CLI
    # takes it. `load_dataset` applies the same overrides again (they are
    # idempotent); here they let an unported branch raise before any work.
    experiment_name = config_lib.suggest_experiment_name(args)
    config_lib.override_default_args(args)
    check_ported(args, config_lib.get_dataset_config(args.dataset))
    device = resolve_device(device)
    if device.type == 'cuda':
        if args.compute_dtype != 'bfloat16':
            raise NotImplementedError(
                f'--compute_dtype {args.compute_dtype} on the card: the '
                'kernels take bfloat16 planes (ROADMAP C)')
        # float32 stays float32 (the encoder, LPIPS, Inception), as every
        # check of the port holds it.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    report_dir = os.path.join(args.root_path, 'reports')
    print('Experiment name:', experiment_name)
    print('Device:', torch.cuda.get_device_name(device)
          if device.type == 'cuda' else device)

    print('Loading data...')
    dataset_config, train_split, train_eval_split, test_split = \
        loaders.load_dataset(args)

    cfg = make_gan_config(args, dataset_config)
    dtype = (torch.bfloat16 if args.compute_dtype == 'bfloat16' else
             torch.float32)
    gen, _ = gan_lib.make_models(cfg, dtype, device)
    if args.resume_from:
        path = ckpt_lib.resolve_gan_checkpoint(args.root_path,
                                               args.resume_from)
        ckpt = ckpt_lib.load(path)
        convert.load_reference_state_dict(gen, ckpt['model_ema'])
        print('Resumed from iteration', int(ckpt.get('iteration', 0)),
              f'({path})')
    else:
        print('WARNING: no --resume_from; inverting a randomly initialized '
              'generator')

    from nerf_from_image_tpu_torch.cli.inversion import run_inversion_cli
    return run_inversion_cli(args, cfg, dataset_config, gen, train_split,
                             train_eval_split, test_split, report_dir,
                             experiment_name, device)


if __name__ == '__main__':
    main()

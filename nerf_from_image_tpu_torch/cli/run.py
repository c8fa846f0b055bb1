"""Flag-compatible entry point (PyTorch port of
`nerf_from_image_tpu/cli/run.py`, the reference's run.py).

    python -m nerf_from_image_tpu_torch.cli.run --dataset p3d_car \\
        --root_path R --data_path D
    python -m nerf_from_image_tpu_torch.cli.run --dataset p3d_car \\
        --run_inversion --resume_from <gan.pth> --coord_resume_from <enc.pth>

`main` parses the JAX CLI's flags (`config.py`), loads the dataset
(`data/loaders.py`) and builds the GAN's configuration. Without
--run_inversion it trains the GAN (`run_training`): a fresh run first
fits the SDF to a sphere (`train/pretrain.py`, 1000 steps), then the
loop (`train/loop.py`) alternates G and D steps, evaluates at iteration
3 and every 5000 (`train/eval.py`: FID with the Inception of
`weights/pt_inception.pth`, or a random one with a warning, and the
image families), and writes `gan_checkpoints/<name>/checkpoint_latest.pth`
(and `best`, and one every 50,000) and the logs under
`gan_logs/<name>/`; a final `latest` closes the run. --resume_from takes
`name` (that run's latest), `name+iter` or a literal `.pth`, all in the
reference's layout; without it a run auto-resumes from its own `latest`
only from iteration 12,500 on, else it trains from scratch.
--compute_dtype (bfloat16 by default) sets the dtype of the training and
pretraining models.

With --run_inversion it restores the EMA generator from --resume_from and
runs the inversion (`cli/inversion.py`) with the generator in float32
whatever --compute_dtype says, as the JAX CLI does. On the card the
kernels read the planes rounded to bfloat16 at every dtype, as the JAX
package's Pallas path does (`ops/triplane_cuda.sample_bf16_planes`).

The demo: --inv_export_demo_sample inverts one batch of the evaluation
set (shuffled) and writes its strip [input | coords | recon | normals |
novel view] to `outputs/sample_<dataset>_<steps>it.png`;
--inv_manual_input_path (which implies it) inverts the user's own image
(a path or a URL; its mask from --inv_manual_mask_path, detectron2 where
installed, the alpha channel, GrabCut or the full frame, `cli/demo.py`)
at batch 1 and writes `outputs/demo_manual_<dataset>_<steps>it.png`.
Every dataset's generator runs: StyleGAN noise (cub, imagenet_elephant),
orthographic cameras (cub) and the view-direction mapper (carla). So do
GAN training's flag-only modes: --use_encoder (G and D conditioned on
the training image; the evaluator's reconstruction metrics with LPIPS,
and the test split's where the dataset has one), --use_class (cub's
class labels; the classes counted in the train split),
--dual_discriminator (with --dual_discriminator_l1/_mse, a
reconstruction loss in D1's place), --path_length_regularization,
--attention_values 0 (no palette) and --perturb_poses (the training
poses moved to neighbours at load, the train-eval split's with them when
the two splits hold the same views).

--profile_trace_at N (an even N) traces the G step of iteration N into
one Chrome trace under `gan_logs/<name>/trace/` (`utils/profiling.py`;
open it in Perfetto or chrome://tracing), as the JAX CLI traces it.

It runs on the card (`main(argv, device='cpu')` on the CPU, as the tests
call it). Not ported yet, and refused with NotImplementedError before any
work, naming its item of ROADMAP queue A (several cards): more than one
device (--mesh_shape, --multihost).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from nerf_from_image_tpu_torch import config as config_lib
from nerf_from_image_tpu_torch.core import pose as pose_lib
from nerf_from_image_tpu_torch.data import loaders
from nerf_from_image_tpu_torch.device import DeviceLike, resolve_device
from nerf_from_image_tpu_torch.train import gan as gan_lib
from nerf_from_image_tpu_torch.train import loop as loop_lib
from nerf_from_image_tpu_torch.train import pretrain
from nerf_from_image_tpu_torch.train.eval import GANEvaluator
from nerf_from_image_tpu_torch.utils import checkpoint as ckpt_lib
from nerf_from_image_tpu_torch.utils import convert
from nerf_from_image_tpu_torch.utils import weights as weights_lib
from nerf_from_image_tpu_torch.utils.logging import SummaryWriter


# A run's own latest checkpoint resumes it only from this iteration on.
AUTO_RESUME_MIN_ITERATION = 12500


def make_gan_config(args, dataset_config: dict,
                    num_classes: Optional[int] = None) -> gan_lib.GANConfig:
    """The GAN's configuration from the flags (after the dataset's
    overrides); `num_classes` is the train split's, for --use_class."""
    return gan_lib.GANConfig(
        resolution=args.resolution, latent_dim=args.latent_dim,
        depth_samples_per_ray=config_lib.depth_samples(args),
        fine_sampling=args.fine_sampling,
        scene_range=dataset_config['scene_range'],
        white_background=dataset_config['white_background'],
        camera_flipped=dataset_config['camera_flipped'],
        supervise_alpha=args.supervise_alpha,
        attention_values=args.attention_values,
        is_highres=dataset_config.get('is_highres', False),
        r1=args.r1, tv=args.tv, entropy=args.entropy, eikonal=args.eikonal,
        augment_ada=args.augment_ada, augment_p_max=args.augment_p,
        ada_target=args.ada_target,
        clip_gradient_norm=args.clip_gradient_norm, lr_g=args.lr_g,
        lr_d=args.lr_d, batch_size=args.batch_size,
        plane_resolution=args.plane_resolution,
        path_length_regularization=args.path_length_regularization,
        dual_discriminator=args.dual_discriminator,
        dual_discriminator_l1=args.dual_discriminator_l1,
        dual_discriminator_mse=args.dual_discriminator_mse,
        use_encoder=args.use_encoder, use_class=args.use_class,
        num_classes=num_classes if args.use_class else None,
        use_viewdir=args.use_viewdir,
        use_stylegan_noise=not args.disable_stylegan_noise)


def main(argv=None, device: DeviceLike = None):
    """Runs the CLI on `device` (None: the card, raising without CUDA).
    Returns what `run_training` or `cli.inversion.run_inversion_cli`
    returns."""
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
    config_lib.check_single_device(args)
    device = resolve_device(device)
    if device.type == 'cuda':
        # float32 stays float32 (the inversion's generator, the encoder,
        # LPIPS, Inception), as every check of the port holds it.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    print('Experiment name:', experiment_name)
    print('Device:', torch.cuda.get_device_name(device)
          if device.type == 'cuda' else device)

    manual_image = None
    if args.inv_manual_input_path:
        from nerf_from_image_tpu_torch.cli.demo import load_manual_image
        manual_image = load_manual_image(
            args.inv_manual_input_path,
            config_lib.get_coco_mapping()[args.dataset],
            mask_path=args.inv_manual_mask_path)

    print('Loading data...')
    dataset_config, train_split, train_eval_split, test_split = \
        loaders.load_dataset(args, manual_image)
    if args.perturb_poses > 0:
        perturb_training_poses(args.perturb_poses, train_split,
                               train_eval_split)

    cfg = make_gan_config(args, dataset_config, train_split.num_classes)
    if not args.run_inversion:
        dtype = (torch.bfloat16 if args.compute_dtype == 'bfloat16' else
                 torch.float32)
        return run_training(args, cfg, dataset_config, train_split,
                            train_eval_split, experiment_name, dtype, device,
                            test_split)

    # The inversion's generator is float32 whatever --compute_dtype says.
    gen, _ = gan_lib.make_models(cfg, torch.float32, device)
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
                             train_eval_split, test_split,
                             os.path.join(args.root_path, 'reports'),
                             experiment_name, device)


def perturb_training_poses(avg_angle: float, train_split,
                           train_eval_split) -> None:
    """--perturb_poses: each training pose (with its focal length and
    bbox) replaced by a neighbour's at about `avg_angle` degrees
    (`core.pose.perturb_poses`, seed 1234); the train-eval split takes
    the same poses when it holds as many."""
    (train_split.tform_cam2world, train_split.focal_length,
     train_split.bbox) = pose_lib.perturb_poses(
        train_split.tform_cam2world, avg_angle, train_split.focal_length,
        train_split.bbox)
    if (train_eval_split.tform_cam2world.shape ==
            train_split.tform_cam2world.shape):
        train_eval_split.tform_cam2world = train_split.tform_cam2world
        train_eval_split.focal_length = train_split.focal_length
        train_eval_split.bbox = train_split.bbox


def run_training(args, cfg: gan_lib.GANConfig, dataset_config: dict,
                 train_split, train_eval_split, experiment_name: str,
                 dtype: torch.dtype, device: torch.device,
                 test_split=None) -> dict:
    """GAN training: resume or pretrain, the loop with its evaluator, and a
    final `latest`. Returns {'state', 'evaluator', 'checkpoint_dir',
    'log_dir', 'pretrained'}."""
    checkpoint_dir = os.path.join(args.root_path, 'gan_checkpoints',
                                  experiment_name)
    log_dir = os.path.join(args.root_path, 'gan_logs', experiment_name)
    ckpt = ckpt_lib.CheckpointManager(checkpoint_dir)

    def fresh_state():
        return gan_lib.init_train_state(cfg, dtype, device, seed=1234)

    state = fresh_state()
    host_state = None  # the resumed checkpoint's random_state
    best_fid = None
    if args.resume_from:
        path = ckpt_lib.resolve_gan_checkpoint(args.root_path,
                                               args.resume_from)
        saved = ckpt_lib.load(path)
        best_fid = ckpt_lib.restore_gan_checkpoint(saved, state).get(
            'best_fid')
        host_state = saved.get('random_state')
        print('Resumed from iteration', state.iteration, f'({path})')
    elif ckpt.exists('latest'):
        # A run's own latest: best-effort, from iteration 12,500 on.
        try:
            saved = ckpt.load('latest')
            if int(saved.get('iteration', 0)) >= AUTO_RESUME_MIN_ITERATION:
                best_fid = ckpt_lib.restore_gan_checkpoint(
                    saved, state).get('best_fid')
                host_state = saved.get('random_state')
                print('Auto-resumed from iteration', state.iteration)
            else:
                print('Aborting resume (training from scratch)')
        except Exception as e:
            print(f'Aborting resume (incompatible latest checkpoint: {e}); '
                  'training from scratch')
            state = fresh_state()
            best_fid = host_state = None

    os.makedirs(checkpoint_dir, exist_ok=True)
    writer = SummaryWriter(log_dir)
    inception = weights_lib.load_inception(args.root_path, device,
                                           random_if_missing=True)
    # The encoder mode's reconstruction metric.
    lpips = (weights_lib.load_lpips(args.root_path, device)
             if args.use_encoder else None)
    evaluator = GANEvaluator(
        cfg, dataset_config, args.dataset, train_split, train_eval_split,
        test_split, inception=inception, lpips=lpips,
        use_encoder=args.use_encoder,
        use_class=args.use_class, eval_batch_size=min(args.batch_size, 8),
        stats_cache_dir=os.path.join(args.root_path, 'fid_stats'),
        device=device)
    if best_fid is not None:
        # checkpoint_best's gate survives restarts.
        evaluator.best_fid = best_fid
    eval_rng = np.random.RandomState(4321)

    def eval_fn(s, i):
        fid, is_best = evaluator.evaluate(s, i, writer)
        if fid is not None:
            print(f'[{i}] FID: {fid:.2f} (best {evaluator.best_fid:.2f})')
        evaluator.log_training_images(s, i, writer, eval_rng)
        return fid, is_best

    pretrained = state.iteration == 0
    if pretrained:
        print('SDF pre-training...')
        pretrain.pretrain_sdf(state, cfg, args.eikonal, lr=args.lr_g)

    loop_lib.train_gan(
        state, cfg, train_split, args.iterations, writer=writer,
        ckpt_manager=ckpt, eval_fn=eval_fn, host_state=host_state,
        host_state_extra=lambda: {'best_fid': evaluator.best_fid},
        profile_trace_at=args.profile_trace_at,
        trace_dir=os.path.join(log_dir, 'trace'))
    # As the JAX CLI's final save: the state without the loop's host state.
    ckpt.save(ckpt_lib.gan_checkpoint(state), 'latest')
    writer.close()
    print('Training done.')
    return {'state': state, 'evaluator': evaluator,
            'checkpoint_dir': checkpoint_dir, 'log_dir': log_dir,
            'pretrained': pretrained}


if __name__ == '__main__':
    main()

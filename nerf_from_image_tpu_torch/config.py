"""Flag-compatible configuration and dataset configs (a copy of
`nerf_from_image_tpu/config.py`, which the port may not import).

Mirrors the reference's arguments.py:18-267 (same flag names/defaults,
including its always-on `type=bool` quirks for --fine_sampling/--use_sdf/
--conditional_pose/--disable_stylegan_noise) and data/loaders.py:23-123
(per-dataset configs + overrides), so that one command line runs both
packages. The JAX package's own flags (--mesh_shape, --multihost,
--use_pallas, --profile_trace_at) are parsed too; the port runs on one
card, and `check_single_device` refuses a layout of more than one
device. `--gpus` is kept for CLI compatibility.
"""

from __future__ import annotations

import argparse


def _always_true_bool(v) -> bool:
    # Matches argparse `type=bool` semantics in the reference: any non-empty
    # string (including 'False') is truthy. Kept for CLI compatibility.
    return bool(v)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--gpus', type=int, default=4,
                        help='Compatibility flag; the port runs on one card')
    parser.add_argument('--dataset', type=str, default='autodetect')
    parser.add_argument('--xid', type=str, default='')
    parser.add_argument('--resolution', type=int, default=128)
    parser.add_argument('--batch_size', type=int, default=32)
    parser.add_argument('--run_inversion', action='store_true')
    parser.add_argument('--resume_from', type=str)
    parser.add_argument('--root_path', type=str, default='.')
    parser.add_argument('--data_path', type=str, default='datasets')

    parser.add_argument('--iterations', type=int, default=300000)
    parser.add_argument('--lr_g', type=float, default=0.0025)
    parser.add_argument('--lr_d', type=float, default=0.002)
    parser.add_argument('--dual_discriminator', action='store_true')
    parser.add_argument('--dual_discriminator_l1', action='store_true')
    parser.add_argument('--dual_discriminator_mse', action='store_true')
    parser.add_argument('--r1', type=float, default=5.0)
    parser.add_argument('--tv', type=float, default=0.5)
    parser.add_argument('--entropy', type=float, default=0.05)
    parser.add_argument('--eikonal', type=float, default=0.1)
    parser.add_argument('--supervise_alpha', action='store_true')
    parser.add_argument('--conditional_pose', type=_always_true_bool,
                        default=True)
    parser.add_argument('--augment_p', type=float, default=0)
    parser.add_argument('--augment_ada', action='store_true')
    parser.add_argument('--ada_target', type=float, default=0.6)
    parser.add_argument('--path_length_regularization', action='store_true')
    parser.add_argument('--perturb_poses', type=float, default=0)
    parser.add_argument('--clip_gradient_norm', type=float, default=100.0)

    parser.add_argument('--fine_sampling', type=_always_true_bool,
                        default=True)
    parser.add_argument('--attention_values', type=int, default=10)
    parser.add_argument('--use_sdf', type=_always_true_bool, default=True)
    parser.add_argument('--use_encoder', action='store_true')
    parser.add_argument('--use_viewdir', action='store_true')
    parser.add_argument('--use_class', action='store_true')
    parser.add_argument('--latent_dim', type=int, default=512)
    parser.add_argument('--disable_stylegan_noise', type=_always_true_bool,
                        default=True)

    parser.add_argument('--inv_use_testset', action='store_true')
    parser.add_argument('--inv_use_imagenet_testset', action='store_true')
    parser.add_argument('--inv_use_separate', action='store_true')
    parser.add_argument('--inv_loss', type=str, default='vgg')
    parser.add_argument('--inv_gain_z', type=int, default=5)
    parser.add_argument('--inv_steps', type=int)
    parser.add_argument('--inv_no_split', action='store_true')
    parser.add_argument('--inv_no_optimize_pose', action='store_true')
    parser.add_argument('--inv_train_coord_only', action='store_true')
    parser.add_argument('--inv_encoder_only', action='store_true')
    parser.add_argument('--inv_export_demo_sample', action='store_true')
    parser.add_argument('--inv_manual_input_path', type=str)
    # Extension: explicit foreground mask for the manual input image
    # (same size, grayscale/binary or RGBA-alpha). Takes precedence over
    # instance segmentation / GrabCut in cli/demo.py.
    parser.add_argument('--inv_manual_mask_path', type=str)
    parser.add_argument('--coord_resume_from', type=str)

    # The JAX package's extensions (not present in the reference).
    parser.add_argument('--mesh_shape', type=str, default='',
                        help='Device mesh, e.g. "data:8" (default: all '
                        'devices on one data axis)')
    parser.add_argument('--compute_dtype', type=str, default='bfloat16',
                        choices=['float32', 'bfloat16'])
    parser.add_argument('--multihost', action='store_true',
                        help='multi-host runs of the JAX package; the '
                        'port runs on one card and refuses it')
    parser.add_argument('--profile_trace_at', type=int, default=0,
                        help='profiler trace around this training '
                             'iteration (0 = disabled; GAN training)')
    parser.add_argument('--use_pallas', type=int, default=1,
                        help='Pallas kernels of the JAX package (the port '
                             'parses and ignores it)')
    parser.add_argument('--plane_resolution', type=int, default=256,
                        help='StyleGAN synthesis / triplane resolution '
                             '(the reference fixes 256; '
                             'models/generator.py:373-377)')
    parser.add_argument('--depth_samples_per_ray', type=int, default=0,
                        help='override depth samples per ray (0 = the '
                             'reference rule: 64 coarse [+64 fine], or 128 '
                             'coarse when fine sampling is off; '
                             'run.py:511-514)')

    args = parser.parse_args(argv)

    if args.dual_discriminator_l1 and not args.dual_discriminator:
        args.dual_discriminator = True
    if args.dual_discriminator_mse and not args.dual_discriminator:
        args.dual_discriminator = True
    return args


def depth_samples(args) -> int:
    """Per-pass depth samples: the reference rule (64 coarse [+64 fine],
    128 coarse without fine sampling; run.py:511-514) unless overridden
    by --depth_samples_per_ray."""
    if args.depth_samples_per_ray:
        return args.depth_samples_per_ray
    return 64 if args.fine_sampling else 128


def suggest_experiment_name(args) -> str:
    """Experiment-name canonicalization (arguments.py:213-267)."""
    name = 'r' if args.use_encoder else 'g'
    name += f'_{args.xid}' if len(args.xid) > 0 else ''
    name += f'_{args.dataset}'
    name += (f'_res{args.resolution}_bs{args.batch_size}_d{args.latent_dim}'
             f'_lrg_{args.lr_g}_lrd_{args.lr_d}')
    if args.r1 > 0:
        name += f'_r1_{args.r1}'
    if args.entropy > 0:
        name += f'_entropy_{args.entropy}'
    if args.tv > 0:
        name += f'_tv_{args.tv}'
    if args.dual_discriminator:
        name += '_dual'
        if args.dual_discriminator_mse:
            name += '_mse'
        elif args.dual_discriminator_l1:
            name += '_l1'
    name += '_fine' if args.fine_sampling else '_nofine'
    name += f'_sdf_eik{args.eikonal}' if args.use_sdf else '_nosdf'
    if args.attention_values > 0:
        name += f'_attn{args.attention_values}'
    name += '_alpha' if args.supervise_alpha else '_noalpha'
    name += '_pose' if args.conditional_pose else '_nopose'
    if args.perturb_poses > 0:
        name += f'_perturb{args.perturb_poses}'
    if args.augment_p > 0:
        name += f'_augment_p{args.augment_p}'
        if args.augment_ada:
            name += f'_ada{args.ada_target}'
    if args.use_viewdir:
        name += '_viewdir'
    if args.use_class:
        name += '_class'
    if args.path_length_regularization:
        name += '_ppl'
    if args.disable_stylegan_noise:
        name += '_nonoise'
    return name


def get_dataset_config(dataset: str) -> dict:
    """Per-dataset rendering/eval config (data/loaders.py:23-87)."""
    if dataset.startswith('shapenet'):
        return dict(scene_range=1.1 / 2, white_background=True,
                    has_mask=False, has_bbox=False, is_highres=False,
                    views_per_object=50, views_per_object_test=251,
                    camera_projection_model='perspective',
                    camera_flipped=False)
    if dataset.startswith('p3d_'):
        return dict(scene_range=1.4, white_background=False, has_mask=True,
                    has_bbox=True, is_highres=True, views_per_object=1,
                    views_per_object_test=1,
                    camera_projection_model='perspective',
                    camera_flipped=True)
    if dataset.startswith('imagenet_'):
        return dict(scene_range=1.4, white_background=False, has_mask=True,
                    has_bbox=True, is_highres=True, views_per_object=1,
                    views_per_object_test=None,
                    camera_projection_model='perspective',
                    camera_flipped=True)
    if dataset == 'cub':
        return dict(scene_range=2.0, white_background=False, has_mask=True,
                    has_bbox=True, is_highres=True, views_per_object=1,
                    views_per_object_test=1,
                    camera_projection_model='ortho', camera_flipped=True)
    if dataset == 'carla':
        return dict(scene_range=3.0, white_background=True, has_mask=False,
                    has_bbox=False, is_highres=True, views_per_object=1,
                    views_per_object_test=None,
                    camera_projection_model='perspective',
                    camera_flipped=False)
    raise ValueError(f'Invalid dataset {dataset!r}')


def override_default_args(args) -> None:
    """Dataset-specific flag overrides (data/loaders.py:90-123)."""
    if args.dataset == 'cub':
        args.iterations = 200000
        args.disable_stylegan_noise = False
        args.supervise_alpha = True
        args.augment_p = 0.8
        args.augment_ada = True
        args.inv_use_testset = True
    if args.dataset.startswith('imagenet'):
        args.supervise_alpha = True
        args.augment_p = 0.8
        args.augment_ada = True
    if args.dataset == 'imagenet_elephant':
        args.iterations = 200000
        args.disable_stylegan_noise = False
        args.r1 = 10.0
    if args.dataset.startswith('p3d'):
        args.supervise_alpha = True
        args.augment_p = 0.8
        args.augment_ada = True
        args.inv_use_testset = True
    if args.dataset == 'carla':
        args.use_viewdir = True
        args.augment_p = 0.8
        args.augment_ada = True
    if args.dataset.startswith('shapenet'):
        args.inv_use_testset = True
        args.inv_no_optimize_pose = True


DATASET_NAMES = (
    'shapenet_cars', 'shapenet_chairs', 'p3d_car', 'cub', 'carla',
    'imagenet_car', 'imagenet_airplane', 'imagenet_motorcycle',
    'imagenet_zebra', 'imagenet_elephant',
)


def get_coco_mapping() -> dict:
    return {'p3d_car': 2, 'cub': 14, 'imagenet_car': 2,
            'imagenet_airplane': 4, 'imagenet_motorcycle': 3,
            'imagenet_zebra': 22, 'imagenet_elephant': 20}


def autodetect_dataset(experiment_name: str) -> str:
    found = None
    for choice in DATASET_NAMES:
        if f'_{choice}_' in experiment_name:
            assert found is None
            found = choice
    if not found:
        raise RuntimeError('Unable to autodetect dataset; pass --dataset')
    return found


def mesh_devices(mesh_shape: str) -> int:
    """The number of devices a --mesh_shape ("data:4,rays:2") asks for;
    1 for the empty default."""
    n = 1
    for part in filter(None, mesh_shape.split(',')):
        n *= int(part.split(':')[1])
    return n


def check_single_device(args) -> None:
    """Raises NotImplementedError for a layout of more than one device
    (ROADMAP queue A: several cards): the port runs on one card."""
    if args.multihost:
        raise NotImplementedError('--multihost: the port runs on one card '
                                  '(ROADMAP queue A: several cards)')
    if mesh_devices(args.mesh_shape) > 1:
        raise NotImplementedError(f'--mesh_shape {args.mesh_shape}: the port '
                                  'runs on one card (ROADMAP queue A: '
                                  'several cards)')

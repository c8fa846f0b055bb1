"""The port's configuration (`nerf_from_image_tpu_torch/config.py`, a copy)
against the JAX package's: the parsed flags of every dataset after its
overrides, field by field, the experiment names, the dataset configs,
the depth rule and the dataset autodetection; and the port's refusal of
layouts of more than one device. All comparisons are exact."""

import pytest

from nerf_from_image_tpu import config as jax_config
from nerf_from_image_tpu_torch import config

EXTRA = (
    [],
    ['--xid', 'x1', '--resolution', '64', '--batch_size', '16',
     '--dual_discriminator_l1', '--augment_p', '0.5', '--augment_ada',
     '--perturb_poses', '0.1', '--use_viewdir', '--use_class',
     '--path_length_regularization', '--fine_sampling', '',
     '--use_sdf', 'False', '--inv_steps', '12', '--depth_samples_per_ray',
     '8', '--compute_dtype', 'float32', '--use_pallas', '0'],
    ['--dual_discriminator_mse', '--attention_values', '0', '--r1', '0',
     '--entropy', '0', '--tv', '0', '--use_encoder',
     '--inv_use_imagenet_testset', '--mesh_shape', 'data:1'],
)


@pytest.mark.parametrize('dataset', config.DATASET_NAMES)
@pytest.mark.parametrize('extra', range(len(EXTRA)))
def test_args_match_jax(dataset, extra):
    argv = ['--dataset', dataset] + EXTRA[extra]
    args, jargs = config.parse_args(argv), jax_config.parse_args(argv)
    config.override_default_args(args)
    jax_config.override_default_args(jargs)
    assert vars(args) == vars(jargs)
    assert (config.suggest_experiment_name(args) ==
            jax_config.suggest_experiment_name(jargs))
    assert config.depth_samples(args) == jax_config.depth_samples(jargs)
    assert (config.get_dataset_config(dataset) ==
            jax_config.get_dataset_config(dataset))


def test_dataset_tables_match_jax():
    assert config.DATASET_NAMES == jax_config.DATASET_NAMES
    assert config.get_coco_mapping() == jax_config.get_coco_mapping()
    name = 'g_x_p3d_car_res128'
    assert (config.autodetect_dataset(name) ==
            jax_config.autodetect_dataset(name) == 'p3d_car')
    for cfg in (config, jax_config):
        with pytest.raises(RuntimeError):
            cfg.autodetect_dataset('nothing')
        with pytest.raises(ValueError):
            cfg.get_dataset_config('mnist')


@pytest.mark.parametrize('argv', [['--mesh_shape', 'data:2'],
                                  ['--mesh_shape', 'data:1,rays:4'],
                                  ['--multihost']])
def test_more_than_one_device_raises(argv):
    with pytest.raises(NotImplementedError, match='several cards'):
        config.check_single_device(config.parse_args(argv))


def test_one_device_passes():
    for argv in ([], ['--mesh_shape', 'data:1'],
                 ['--mesh_shape', 'data:1,rays:1']):
        config.check_single_device(config.parse_args(argv))
    assert config.mesh_devices('data:2,rays:3') == 6

"""Every public name of the JAX package has its counterpart in the port.

Both packages are parsed with `ast`; neither is imported. For each module
of `nerf_from_image_tpu/`, every public top-level function and class and
every public method of those classes (defined at the top level or in a
top-level `if`/`try` block) must be defined by the port module of the
same relative path, or be a row of `ELSEWHERE`: its counterpart elsewhere
in the port, or the reason it has none. A name added to the JAX package
later that is in neither place fails here. A JAX module without a module
of the same path in the port must be a row of `NO_MODULE`.
"""

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX = REPO / 'nerf_from_image_tpu'
PORT = REPO / 'nerf_from_image_tpu_torch'

# Why a JAX name has no namesake at the same path in the port.
TPU = 'TPU mechanism'  # Pallas, packed quads, XLA sorting, shardings
SETUP = 'flax setup'  # the port's modules build their layers in __init__
ORBAX = 'orbax checkpoint or npz weight cache'  # the port reads .pth
CONVERTER = 'JAX-side converter'  # torch weights into flax variables
NO_CALLER = 'no JAX caller'
RENAMED = 'renamed counterpart'
NOT_PORTED = 'not ported'
CATEGORIES = (TPU, SETUP, ORBAX, CONVERTER, NO_CALLER, RENAMED, NOT_PORTED)

NO_MODULE = {
    'ops/pallas/__init__.py': TPU,
    'ops/pallas/triplane_window.py': TPU,
    'ops/pallas/warp.py': TPU,
    'utils/torch_convert.py': CONVERTER,
}

# 'JAX module:name' -> (category, detail). For RENAMED the detail is the
# counterpart as 'port module:name', which must exist; else the reason.
GS = ('gs:// paths through etils or TensorFlow; the card\'s machine has '
      'neither and no network. Local paths: Python\'s open, '
      'os.path.exists and os.makedirs')
ELSEWHERE = {
    # The JAX CLIs' weight loading, as the port's loaders.
    'cli/inversion.py:compute_view_perm': (
        RENAMED, 'train/eval.py:compute_view_perm'),
    'cli/inversion.py:load_inception_apply': (
        RENAMED, 'utils/weights.py:load_inception'),
    'cli/inversion.py:load_lpips_vars': (
        RENAMED, 'utils/weights.py:load_lpips'),
    'cli/run.py:convert_reference_checkpoint': (
        CONVERTER, 'reference .pth -> orbax; the port trains on the '
                   'reference .pth itself'),
    'cli/run.py:make_inception_apply': (
        RENAMED, 'utils/weights.py:load_inception'),
    'cli/run.py:make_lpips_apply': (RENAMED, 'utils/weights.py:load_lpips'),
    'cli/train_encoder.py:graft_segformer_backbone': (
        RENAMED, 'utils/weights.py:graft_mit_backbone'),
    'core/compositing.py:compute_weights_unsorted': (
        TPU, 'compositing without XLA\'s sort'),
    # Its one caller is the reference triplane sampler, whose counterpart
    # samples each plane with border padding and align_corners=True.
    'core/grids.py:grid_sample2d': (
        RENAMED, 'ops/triplane.py:sample_triplane_plain'),
    'core/rays.py:lax_stop': (TPU, 'jax.lax.stop_gradient; Tensor.detach'),
    'core/sampling.py:sort_merge': (TPU, 'merges sorted depths for XLA'),
    'data/datasets.py:imread': (RENAMED, 'data/image_io.py:imread'),
    'data/datasets.py:resize_area': (RENAMED, 'data/image_io.py:resize_area'),
    'models/discriminator.py:Discriminator.setup': (SETUP, ''),
    'models/generator.py:Generator.decode': (
        RENAMED, 'models/generator.py:Generator.sample'),
    'models/generator.py:Generator.resolve_noise_mode': (
        RENAMED, 'models/generator.py:Generator.noise_mode'),
    'models/generator.py:Generator.setup': (SETUP, ''),
    # `Generator.texture_mapper(w)`, which `synthesize` calls.
    'models/generator.py:Generator.texture': (
        RENAMED, 'models/generator.py:AttentionMapper.forward'),
    'models/generator.py:GeneratorState.plane_resolution': (
        TPU, 'R of the packed planes and of the Pallas window choice; the '
             'port\'s wrappers read R from the planes\' shape'),
    'models/generator.py:TriplanarDecoder.setup': (SETUP, ''),
    'models/generator.py:ViewDirectionMapper.setup': (SETUP, ''),
    'models/lpips.py:LPIPS.features': (
        RENAMED, 'models/lpips.py:LPIPS.layer_features'),
    'models/lpips.py:LPIPS.setup': (SETUP, ''),
    'models/stylegan.py:SynthesisNetwork.num_ws': (
        NO_CALLER, 'the mapping network broadcasts to Generator.num_ws'),
    'models/stylegan.py:bilinear_filter': (
        RENAMED, 'ops/resample.py:bilinear_filter'),
    'models/stylegan.py:downsample2d': (
        RENAMED, 'ops/resample.py:downsample2d'),
    'models/stylegan.py:filter2d': (RENAMED, 'ops/resample.py:filter2d'),
    'models/stylegan.py:upsample2d': (RENAMED, 'ops/resample.py:upsample2d'),
    # The Pallas kernels B1-B6 and their plumbing: the port's sm_90a
    # kernels (ops/csrc/) behind these wrappers.
    'ops/pallas/triplane_window.py:plane_layout_for_dma': (
        TPU, 'the planes\' HBM layout for the window DMAs'),
    'ops/pallas/triplane_window.py:prepare_blocks': (
        TPU, 'points blocked by ray tile and depth slab for the windows'),
    'ops/pallas/triplane_window.py:sample_triplane_windowed': (
        RENAMED, 'ops/triplane_cuda.py:sample_triplane'),
    'ops/pallas/triplane_window.py:sample_windowed_raw': (
        RENAMED, 'ops/triplane_cuda.py:launch'),
    'ops/pallas/triplane_window.py:unblock_points': (
        TPU, 'undoes prepare_blocks'),
    'ops/pallas/triplane_window.py:windowed_core': (
        RENAMED, 'ops/triplane.py:TriplaneSample'),
    'ops/pallas/triplane_window.py:windowed_core_planes': (
        RENAMED, 'ops/triplane.py:TriplaneSample'),
    'ops/pallas/triplane_window.py:windowed_grad': (
        RENAMED, 'ops/triplane_cuda.py:launch_grad'),
    'ops/pallas/triplane_window.py:windowed_grad_planes': (
        RENAMED, 'ops/triplane_cuda.py:launch_grad_planes'),
    'ops/pallas/warp.py:grid_sample_zeros_windowed': (
        RENAMED, 'ops/warp.py:grid_sample_zeros'),
    'ops/triplane.py:pack_plane_quads': (TPU, 'packed quads'),
    'ops/triplane.py:pack_triplane': (TPU, 'packed quads'),
    'ops/triplane.py:sample_packed_triplane': (TPU, 'packed quads'),
    'ops/triplane.py:sample_plane_packed': (TPU, 'packed quads'),
    'ops/triplane.py:sample_triplane': (
        RENAMED, 'ops/triplane_cuda.py:sample_triplane'),
    'ops/triplane.py:sample_triplane_reference': (
        RENAMED, 'ops/triplane.py:sample_triplane_plain'),
    'parallel/mesh.py:batch_spec': (TPU, 'a jit sharding'),
    'parallel/mesh.py:replicated_spec': (TPU, 'a jit sharding'),
    'train/gan.py:blur_kernel_dynamic': (
        RENAMED, 'core/grids.py:blur_kernel_1d'),
    'train/gan.py:make_optimizers': (RENAMED, 'train/gan.py:make_optimizer'),
    # torch Adam moments into optax; the port's Adam loads them as saved.
    'train/gan.py:restore_adam_moments': (
        RENAMED, 'utils/checkpoint.py:restore_gan_checkpoint'),
    'utils/checkpoint.py:CheckpointManager.metadata': (
        ORBAX, 'the JSON beside an orbax checkpoint; the .pth holds it'),
    'utils/checkpoint.py:CheckpointManager.restore': (
        RENAMED, 'utils/checkpoint.py:CheckpointManager.load'),
    'utils/checkpoint.py:CheckpointManager.restore_host_state': (
        RENAMED, 'utils/checkpoint.py:restore_loop_state'),
    'utils/checkpoint.py:apply_host_state': (
        RENAMED, 'utils/checkpoint.py:restore_loop_state'),
    'utils/checkpoint.py:load_metadata': (
        ORBAX, 'the JSON beside an orbax checkpoint; the .pth holds it'),
    'utils/checkpoint.py:pack_host_state': (
        RENAMED, 'utils/checkpoint.py:gan_checkpoint'),
    'utils/checkpoint.py:restore_pytree': (ORBAX, ''),
    'utils/checkpoint.py:save_pytree': (ORBAX, ''),
    'utils/io.py:file_exists': (NOT_PORTED, GS),
    'utils/io.py:mkdir': (NOT_PORTED, GS),
    'utils/io.py:open_file': (NOT_PORTED, GS),
    'utils/profiling.py:StageTimer': (NO_CALLER, ''),
    'utils/profiling.py:StageTimer.scalars': (NO_CALLER, ''),
    'utils/profiling.py:StageTimer.stage': (NO_CALLER, ''),
    'utils/profiling.py:Throughput': (NO_CALLER, ''),
    'utils/profiling.py:Throughput.start': (NO_CALLER, ''),
    'utils/profiling.py:Throughput.stop': (NO_CALLER, ''),
    'utils/weights.py:flatten_variables': (ORBAX, ''),
    'utils/weights.py:load_npz_variables': (ORBAX, ''),
    'utils/weights.py:save_npz_variables': (ORBAX, ''),
}
for _name in ('convert_adam_moments', 'convert_attention_mapper',
              'convert_bootstrap_encoder', 'convert_discriminator',
              'convert_generator', 'convert_inception', 'convert_lpips',
              'convert_mapping', 'convert_residual_encoder',
              'convert_seg_block', 'convert_segformer', 'convert_synthesis',
              'convert_viewdir_mapper', 'load_torch_state_dict',
              'param_names_in_order'):
    ELSEWHERE[f'utils/torch_convert.py:{_name}'] = (CONVERTER, '')


def _top_level(body):
    """Definitions at the top of `body` and in its `if` and `try` blocks."""
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            yield node
        elif isinstance(node, ast.If):
            yield from _top_level(node.body + node.orelse)
        elif isinstance(node, ast.Try):
            yield from _top_level(node.body + node.orelse + node.finalbody
                                  + [n for h in node.handlers
                                     for n in h.body])


def public_names(path: pathlib.Path) -> set:
    """A module's public functions, classes and `Class.method`s."""
    names = set()
    for node in _top_level(ast.parse(path.read_text()).body):
        if node.name.startswith('_'):
            continue
        names.add(node.name)
        if isinstance(node, ast.ClassDef):
            names.update(f'{node.name}.{sub.name}'
                         for sub in _top_level(node.body)
                         if not sub.name.startswith('_'))
    return names


def _all_names(path: pathlib.Path) -> set:
    """Every function, class and `Class.method` of a module, private ones
    too (a counterpart may be a method such as `forward`)."""
    names = set()
    for node in _top_level(ast.parse(path.read_text()).body):
        names.add(node.name)
        if isinstance(node, ast.ClassDef):
            names.update(f'{node.name}.{sub.name}'
                         for sub in _top_level(node.body))
    return names


JAX_MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob('*.py'))


@pytest.mark.parametrize('module', JAX_MODULES)
def test_every_public_name_has_a_counterpart(module):
    port = PORT / module
    if not port.exists():
        assert module in NO_MODULE, f'no port module {module}'
        ported = set()
    else:
        assert module not in NO_MODULE, f'{module} is ported now'
        ported = public_names(port)
    missing = sorted(name for name in public_names(JAX / module)
                     if name not in ported
                     and f'{module}:{name}' not in ELSEWHERE)
    assert not missing, (f'{module}: {missing} neither in the port module '
                         'nor in ELSEWHERE')


RENAMED_ROWS = sorted(key for key, (category, _) in ELSEWHERE.items()
                      if category == RENAMED)


@pytest.mark.parametrize('key', RENAMED_ROWS)
def test_renamed_counterpart_exists(key):
    target = ELSEWHERE[key][1]
    module, name = target.split(':')
    assert (PORT / module).exists(), target
    assert name in _all_names(PORT / module), target


def test_every_row_names_a_jax_name_the_port_lacks():
    """No stale row: each names a public JAX name that the port module of
    the same path does not define, under a known category; `gs://` is the
    one function left unported."""
    for key, (category, detail) in ELSEWHERE.items():
        module, name = key.split(':')
        assert category in CATEGORIES, key
        assert name in public_names(JAX / module), f'{key}: no such name'
        port = PORT / module
        assert not (port.exists() and name in public_names(port)), (
            f'{key}: the port defines it at the same path now')
        assert detail or category not in (RENAMED, NOT_PORTED), key
    assert sorted(k for k, (c, _) in ELSEWHERE.items()
                  if c == NOT_PORTED) == [
        'utils/io.py:file_exists', 'utils/io.py:mkdir',
        'utils/io.py:open_file']
    for module, category in NO_MODULE.items():
        assert (JAX / module).exists() and not (PORT / module).exists()
        assert category in CATEGORIES

#!/usr/bin/env python3
"""How reproducible the inversion CLI's evaluation render is in p3d_car's
geometry, as a yardstick for the image metrics of
`tests/test_torch_port_cli_inversion.py::test_cli_matches_jax_encoder_only`.

Builds the test's generator (the full-width generator at 32^2 planes,
latent 512, four attention values, seed 3, the decoder's distance output
lowered by 1.5) and eight p3d_car cameras (render box 1.4 = the field's
box, flipped perspective camera, focal from z0 = 1.39, random azimuths),
then renders the front view three ways from the same weights and
parameters: the port's `render_from_params` (float32, unfused), the JAX
package's inside one `jax.jit` (as its CLI's evaluation runs it) and the
JAX package's run eagerly, stage by stage. Prints, for rgb, mask and
depth, the largest difference of each pair and how many values differ by
more than 1e-3, and how many mask pixels sit on the other side of 0.5
(the IoU's cut) in each pair.

The first coarse sample of each ray that enters the box lies on the
box's face, where the field is cut off; how a program rounds that
sample's position decides whether it counts, so JAX against itself
parts as far as the port parts from it.

`--dataset shapenet_cars` renders in ShapeNet's geometry instead (box
0.55, white background, unflipped camera, z0 0.0495 and the scales and
offsets the ShapeNet CLI test's encoder gives), and `--sdf_shift` moves
the decoder's distance output (default -1.5, the tests' surface; +0.5 is
the thin field of `tests/test_torch_port_{shapenet,imagenet}.py`).

Needs JAX and the JAX package beside the port (the CPU machine of the
tests). About a minute on the CPU.

    python3 probes/cli_render_witness.py [--dataset shapenet_cars]
        [--sdf_shift 0.5]
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from nerf_from_image_tpu.invert import optimizer as jax_inv  # noqa: E402
from nerf_from_image_tpu.models.generator import \
    Generator as JaxGenerator  # noqa: E402
from nerf_from_image_tpu.utils import torch_convert  # noqa: E402
from nerf_from_image_tpu_torch.invert import optimizer as inv  # noqa: E402
from nerf_from_image_tpu_torch.train import gan  # noqa: E402

BATCH, RES, SAMPLES = 8, 32, 4
# (box, white background, flipped camera, z0, range of s, range of t2)
GEOMETRY = {'p3d_car': (1.4, False, True, 1.3884684, (0.3, 0.5), 0.2),
            'shapenet_cars': (0.55, True, False, 0.04953393, (0.5, 1.5),
                              1.1)}


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument('--dataset', choices=sorted(GEOMETRY),
                        default='p3d_car')
    parser.add_argument('--sdf_shift', type=float, default=-1.5)
    args = parser.parse_args()
    BOX, white, flipped, z0, s_range, t_range = GEOMETRY[args.dataset]
    cfg = gan.GANConfig(resolution=RES, latent_dim=512, attention_values=4,
                        plane_resolution=32, scene_range=BOX)
    gen = gan.init_train_state(cfg, device='cpu', seed=3).gen_ema
    with torch.no_grad():
        gen.decoder.net[2].bias[0] += args.sdf_shift
    sd = {k: v.numpy() for k, v in gen.state_dict().items()}
    variables = jax.tree_util.tree_map(jnp.asarray,
                                       torch_convert.convert_generator(
                                           sd, attention_values=4,
                                           plane_resolution=32))
    jgen = JaxGenerator(latent_dim=512, scene_range=BOX, attention_values=4,
                        img_resolution=32, use_pallas=False)

    rng = np.random.default_rng(0)
    theta = rng.uniform(-np.pi, np.pi, BATCH)
    quat = np.stack((np.cos(theta / 2), np.zeros(BATCH), np.sin(theta / 2),
                     np.zeros(BATCH)), axis=-1)
    quat = quat + rng.standard_normal((BATCH, 4)) * 0.1
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    with torch.no_grad():
        ws = gen.map(torch.from_numpy(rng.standard_normal(
            (BATCH, 512)).astype(np.float32)))
    params = inv.InversionParams(
        z=ws / 5.0, R=torch.tensor(quat, dtype=torch.float32),
        s=torch.tensor(rng.uniform(*s_range, BATCH), dtype=torch.float32),
        t2=torch.tensor(rng.uniform(-t_range, t_range, (BATCH, 2)),
                        dtype=torch.float32),
        z0=torch.full((BATCH,), z0))
    port_cfg = inv.InversionConfig(resolution=RES,
                                   depth_samples_per_ray=SAMPLES,
                                   scene_range=BOX, white_background=white,
                                   camera_flipped=flipped)
    with torch.no_grad():
        port, _, _ = inv.render_from_params(gen, params, port_cfg)
    jcfg = jax_inv.InversionConfig(resolution=RES,
                                   depth_samples_per_ray=SAMPLES,
                                   scene_range=BOX, white_background=white,
                                   camera_flipped=flipped, lr_gain_z=5.0)
    jparams = jax_inv.InversionParams(**{
        name: jnp.asarray(t.numpy()) for name, t in params.named()})
    jitted, _, _ = jax.jit(lambda v, p: jax_inv.render_from_params(
        jgen, v, p, jcfg))(variables, jparams)
    eager, _, _ = jax_inv.render_from_params(jgen, variables, jparams, jcfg)

    outs = {'port': port, 'jax_jit': jitted, 'jax_eager': eager}
    print(f'{args.dataset}: {BATCH} views of {RES}x{RES}, box {BOX}, SDF '
          f'shift {args.sdf_shift}; mask mean '
          f'{float(port.mask.mean()):.4f}')
    for a, b in (('port', 'jax_jit'), ('port', 'jax_eager'),
                 ('jax_jit', 'jax_eager')):
        line = [f'{a} vs {b}:']
        for key in ('rgb', 'mask', 'depth'):
            x = np.asarray(getattr(outs[a], key), np.float64)
            y = np.asarray(getattr(outs[b], key), np.float64)
            diff = np.abs(x - y)
            diff = diff[np.isfinite(diff)]
            line.append(f'{key} max {diff.max():.3g} '
                        f'({int((diff > 1e-3).sum())} of {x.size} > 1e-3)')
        ma = np.asarray(getattr(outs[a], 'mask')) > 0.5
        mb = np.asarray(getattr(outs[b], 'mask')) > 0.5
        line.append(f'mask pixels across 0.5: {int((ma != mb).sum())}')
        print(' '.join(line))


if __name__ == '__main__':
    main()

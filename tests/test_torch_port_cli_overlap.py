"""The port's inversion CLI's own batch loop, at --inv_steps 2 over 16
images (the fixture and flags of `test_torch_port_cli_inversion.py`): the
second batch, whose PnP ran on the worker thread while the first batch's
steps were queued, equals a serial `bootstrap_batch` +
`evaluate_checkpoint` of the same images exactly; a run resumed from a
report checkpoint at image 8 ends with the uninterrupted run's report
exactly; the `monitor_b0/*` and `report/*` scalars land in
scalars.jsonl. A file of its own, so that a run split by file puts it
beside the rest of the CLI's cases rather than after them.
"""

import os
import shutil

import numpy as np
import torch

from nerf_from_image_tpu_torch.cli import inversion as cli_inv
from nerf_from_image_tpu_torch.cli import run as cli_run
from nerf_from_image_tpu_torch.invert import optimizer as inv_opt
from nerf_from_image_tpu_torch.invert import pipeline as pipe
from nerf_from_image_tpu_torch.invert import pnp
from nerf_from_image_tpu_torch.models.encoder import BootstrapEncoder
from nerf_from_image_tpu_torch.train import gan
from nerf_from_image_tpu_torch.utils import checkpoint
from nerf_from_image_tpu_torch.utils import convert
from nerf_from_image_tpu_torch.utils import weights

from test_torch_port_cli_inversion import (CFG_STRING, KNOBS, _scalars,
                                           _splits, assets)  # noqa: F401


def test_loop_overlap_resume_and_logs(assets, monkeypatch):
    monkeypatch.chdir(assets)
    argv = KNOBS + ['--resume_from', 'gan.pth', '--data_path',
                    str(assets / 'data16'), '--coord_resume_from',
                    str(assets / 'enc.pth'), '--inv_steps', '2']
    kept = {}
    save = pipe.save_report_checkpoint

    def keep_at_8(path, report, idx, key):
        save(path, report, idx, key)
        if idx == 8:
            kept['path'] = path + '.at8'
            shutil.copy(path, kept['path'])

    monkeypatch.setattr(pipe, 'save_report_checkpoint', keep_at_8)
    monkeypatch.setattr(cli_inv, 'REPORT_CHECKPOINT_EVERY', 8)
    first_root = str(assets / 'loop_a')
    out = cli_run.main(argv + ['--root_path', first_root], device='cpu')
    assert [b['images'] for b in out['batches']] == [8, 8]
    assert [b['serial'] for b in out['batches']] == [True, False]
    assert out['batches'][1]['pnp_wait_s'] >= 0
    for key in ('encoder_ms', 'evaluation 0_ms', 'steps_ms',
                'evaluation 2_ms'):
        assert all(b[key] > 0 for b in out['batches']), key

    tags = {s['tag'] for s in _scalars(out['report_dir'])}
    for pname in ('psnr', 'lpips', 'rot_error', 'grad_norm_z',
                  'grad_norm_R', 'grad_norm_s', 'grad_norm_t',
                  'grad_norm_f'):
        assert f'monitor_b0/{pname}' in tags, pname
    for name in ('psnr', 'ssim', 'lpips', 'iou'):
        assert f'report/{name}' in tags, name
    monitor = [s for s in _scalars(out['report_dir'])
               if s['tag'] == 'monitor_b0/psnr']
    assert [s['step'] for s in monitor] == [0, 1]

    # The second batch's step-0 entries against the serial path.
    dataset_config, train, train_eval, test = _splits(str(assets / 'data16'))
    rng = np.random.RandomState(1234)
    cli_inv.build_eval_indices(train_eval, 8000, 1, rng)
    cli_inv.build_eval_indices(test, 8000, 1, rng)
    tsel = cli_inv.select_inversion_targets(
        'p3d_car', dataset_config, True, False, train, train_eval, test,
        test.eval_indices[8:16], test.eval_indices_perm[8:16])
    t = {k: None if v is None else torch.as_tensor(
        np.ascontiguousarray(v), dtype=torch.float32)
        for k, v in tsel.items() if k != 'perm_cameras'}
    perm = tuple(None if v is None else torch.as_tensor(v)
                 for v in tsel['perm_cameras'])
    cfg = gan.GANConfig(resolution=32, latent_dim=512, attention_values=4,
                        plane_resolution=32, scene_range=1.4)
    gen, _ = gan.make_models(cfg, device='cpu')
    convert.load_reference_state_dict(
        gen, checkpoint.load(str(assets / 'gan.pth'))['model_ema'])
    encoder = BootstrapEncoder(512, device='cpu').eval()
    encoder.load_state_dict(checkpoint.encoder_state_dict(
        checkpoint.load(str(assets / 'enc.pth'))))
    with torch.no_grad():
        z_avg = gen.average_w(torch.Generator().manual_seed(1234), 10000)
    _, _, z_init, cam2world, focal, _ = pipe.bootstrap_batch(
        encoder, t['target_img'], pnp.get_focal_guesses(train.focal_length),
        z_avg, 5.0)
    params = pipe.init_inversion_params(z_init, cam2world, focal, True)
    inv_cfg = inv_opt.InversionConfig(
        resolution=32, depth_samples_per_ray=4, scene_range=1.4,
        white_background=False, camera_flipped=True)
    entry = pipe.make_report([0])[0]
    pipe.evaluate_checkpoint(
        pipe.EvalContext(gen=gen, lpips=weights.load_lpips(first_root,
                                                            'cpu'),
                         has_mask=True), inv_cfg, params, entry,
        t['target_img_fid'], None, None, t['gt_cam2world'],
        perm_cameras=perm, compute_rot_error=False)
    for key, values in entry.items():
        if values:
            np.testing.assert_array_equal(out['report'][0][key][8:],
                                          values[0], err_msg=key)

    # Resumed at image 8 from the report checkpoint: the same report.
    second_root = str(assets / 'loop_b')
    report_dir = os.path.join(second_root, 'reports', 'gan.pth', CFG_STRING)
    os.makedirs(report_dir)
    shutil.copy(kept['path'],
                os.path.join(report_dir, 'report_checkpoint.npz'))
    resumed = cli_run.main(argv + ['--root_path', second_root],
                           device='cpu')
    assert [b['images'] for b in resumed['batches']] == [8]
    assert resumed['report'].keys() == out['report'].keys()
    for step, entry in out['report'].items():
        assert resumed['report'][step].keys() == entry.keys()
        for key, value in entry.items():
            np.testing.assert_array_equal(resumed['report'][step][key],
                                          value, err_msg=f'{step}/{key}')
    assert not any(s['tag'].startswith('monitor_b0')
                   for s in _scalars(resumed['report_dir']))

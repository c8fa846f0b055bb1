"""Dual discriminators: one G step and one D step in both packages (the
harness and its tolerances: `tests/torch_port_flag_steps.py`), without
an encoder (D2 is D1 over the second batches) and with one (D2 a
separate D that never sees the image; G renders the same latents and
conditioning from the second poses; each adversarial loss halved; D1's
metrics `_cond`, ADA listening to D2)."""

import pytest

import torch_port_flag_steps as harness

MODES = ('dual_shared', 'dual_encoder')


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def results():
    return {mode: harness.run_mode(mode) for mode in MODES}


@pytest.mark.parametrize('mode', MODES)
def test_step_metrics_match_jax(results, mode):
    checked = harness.check_metrics(results[mode])
    assert {(0, 'loss_g_uncond'), (1, 'loss_d_real_cond'),
            (1, 'loss_r1_uncond')} <= set(checked)
    assert ((1, 'grad_norm_d2') in checked) == (mode == 'dual_encoder')


@pytest.mark.parametrize('mode', MODES)
def test_parameters_after_steps_match_jax(results, mode):
    harness.check_params(results[mode])


def test_second_discriminator_layout(results):
    shared = results['dual_shared']['state']
    assert shared.disc2 is None and shared.opt_d2 is None
    separate = results['dual_encoder']['state']
    assert hasattr(separate.disc, 'emb')
    assert not hasattr(separate.disc2, 'emb')
    assert (separate.disc2.backbone.mapping.fc0.weight.shape[1] == 13)

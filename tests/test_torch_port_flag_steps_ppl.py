"""Path-length regularization and class conditioning: one G step and one
D step of each in both packages (the harness and its tolerances:
`tests/torch_port_flag_steps.py`). PPL's penalty runs its own backward
through the synthesis (a double backward, no kernel) and starts the
running average from the batch's mean; class conditioning embeds the
batch's labels for G's mapping and D's conditioning."""

import pytest

import torch_port_flag_steps as harness

MODES = ('ppl', 'class')


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
    if mode == 'ppl':
        assert (0, 'loss_ppl') in checked


@pytest.mark.parametrize('mode', MODES)
def test_parameters_after_steps_match_jax(results, mode):
    harness.check_params(results[mode])


def test_ppl_running_average_matches_jax(results):
    r = results['ppl']
    got, ref = r['state'].ppl_running_avg, float(r['jstate'].ppl_running_avg)
    assert ref > 0 and harness.rel(got, ref) < harness.RTOL


def test_class_tables_are_trained(results):
    r = results['class']
    state = r['state']
    assert state.gen.class_embedding.weight.shape == (harness.CLASSES, 512)
    assert state.disc.label_embedding.weight.shape == (harness.CLASSES, 512)
    assert not hasattr(state.disc, 'emb')

"""--profile_trace_at: the training CLI's profiler trace.

- `utils.profiling.trace` writes one Chrome trace (a JSON object with
  `traceEvents`, the traced operators among them) under its directory on
  exit, and nothing when disabled.
- The training CLI on a p3d_car fixture, narrowed as in
  `test_torch_port_cli_datasets.test_training_cli_runs` (channel_base
  1024, two pretraining steps, the narrow Inception stand-in), 4
  iterations with the iteration-3 evaluation: with --profile_trace_at 2
  exactly one trace appears under `gan_logs/<name>/trace/`, holding the
  traced G step's operators; with 1 (a D iteration, as in JAX's loop)
  and with 0, no trace directory appears.
"""

import json
import os

import pytest
import torch

from nerf_from_image_tpu_torch.utils import profiling
from test_torch_port_train_cli import (Calls, _patch_port, _run_port_cli,
                                       cli_data)  # noqa: F401
from test_torch_port_train_cli import one_torch_thread  # noqa: F401


def _traces(trace_dir):
    if not os.path.isdir(trace_dir):
        return []
    return sorted(os.listdir(trace_dir))


def test_trace_writes_one_chrome_trace(tmp_path):
    trace_dir = str(tmp_path / 'trace')
    with profiling.trace(trace_dir, device=torch.device('cpu')):
        torch.ones(8, 8).matmul(torch.ones(8, 8))
    files = _traces(trace_dir)
    assert len(files) == 1 and files[0].endswith(profiling.TRACE_SUFFIX)
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)['traceEvents']
    assert any('matmul' in e.get('name', '') for e in events)


def test_trace_disabled_writes_nothing(tmp_path):
    trace_dir = str(tmp_path / 'trace')
    with profiling.trace(trace_dir, enabled=False) as prof:
        torch.ones(4).sum()
    assert prof is None and not os.path.exists(trace_dir)


@pytest.mark.parametrize('at,traced', [(2, True), (1, False), (0, False)])
def test_cli_traces_the_g_step_of_its_iteration(cli_data, monkeypatch,  # noqa: F811
                                                at, traced):
    _patch_port(monkeypatch, Calls())
    out = _run_port_cli(cli_data / f'profile_{at}', cli_data / 'data',
                        ['--iterations', '4', '--profile_trace_at', str(at)])
    assert out['state'].iteration == 4
    files = _traces(os.path.join(out['log_dir'], 'trace'))
    assert len(files) == (1 if traced else 0), files
    if traced:
        with open(os.path.join(out['log_dir'], 'trace', files[0])) as f:
            names = {e.get('name', '') for e in json.load(f)['traceEvents']}
        # The G step's render and its backward ran inside the trace.
        assert any('grid_sampler' in n or 'index_select' in n
                   for n in names), sorted(names)[:20]
        assert any('backward' in n.lower() for n in names)

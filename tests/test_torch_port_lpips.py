"""The port's LPIPS against the JAX package's.

One reference-format state dict (torchvision `features.*` and lpips
`lin<i>.model.1.weight`, drawn from a seed by
`utils.convert.random_lpips_state_dicts`) feeds both packages: the port
through `load_lpips_state_dicts`, JAX through its own
`utils/torch_convert.py:convert_lpips`. Both score the same image pairs
in float32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.models.lpips import LPIPS as JaxLPIPS
from nerf_from_image_tpu.utils import torch_convert
from nerf_from_image_tpu_torch.models.lpips import LPIPS
from nerf_from_image_tpu_torch.utils import convert


@pytest.fixture(scope='module')
def weights():
    return convert.random_lpips_state_dicts(0)


def _pairs(seed, n=3, res=32):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (n, 3, res, res)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), -1, 1).astype(np.float32)
    return a, b


def test_lpips_matches_jax(weights):
    """Distances and their gradient to the first image: 1e-4 relative
    (float32 convolutions summed in another order)."""
    vgg_sd, lin_sd = weights
    port = LPIPS(device='cpu')
    convert.load_lpips_state_dicts(port, vgg_sd, lin_sd)
    jax_vars = torch_convert.convert_lpips(vgg_sd, lin_sd)
    a, b = _pairs(0)

    x = torch.tensor(a).requires_grad_()
    d = port(x, torch.tensor(b))
    assert d.shape == (3, 1, 1, 1)
    dx, = torch.autograd.grad(d.sum(), x)

    lp = JaxLPIPS()

    @jax.jit
    def jax_value_and_grad(im):
        ref, vjp = jax.vjp(lambda x: lp.apply(jax_vars, x, jnp.asarray(b)),
                           im)
        return ref, vjp(jnp.ones_like(ref))[0]

    ref, ref_dx = jax_value_and_grad(jnp.asarray(a))
    np.testing.assert_allclose(d.detach().reshape(-1).numpy(),
                               np.asarray(ref).reshape(-1), rtol=1e-4,
                               atol=1e-6)
    ref_dx = np.asarray(ref_dx)
    assert np.abs(dx.numpy() - ref_dx).max() <= 1e-4 * np.abs(ref_dx).max()
    assert float(d.detach().min()) > 0


def test_state_dict_keys_are_the_reference_names(weights):
    """The port's keys are exactly the two reference dicts' keys, and the
    strict load puts each reference tensor under its own key."""
    vgg_sd, lin_sd = weights
    port = LPIPS(device='cpu')
    assert set(port.state_dict()) == set(vgg_sd) | set(lin_sd)
    convert.load_lpips_state_dicts(port, vgg_sd, lin_sd)
    for key, value in port.state_dict().items():
        ref = vgg_sd[key] if key in vgg_sd else lin_sd[key]
        assert np.array_equal(value.numpy(), ref), key
    with pytest.raises(RuntimeError):
        convert.load_lpips_state_dicts(
            LPIPS(device='cpu'), vgg_sd,
            {k: v for k, v in lin_sd.items() if not k.startswith('lin4')})


def test_lpips_of_an_image_with_itself_is_zero(weights):
    port = LPIPS(device='cpu')
    convert.load_lpips_state_dicts(port, *weights)
    a, _ = _pairs(1, n=2)
    with torch.no_grad():
        d = port(torch.tensor(a), torch.tensor(a))
    assert float(d.abs().max()) == 0.0

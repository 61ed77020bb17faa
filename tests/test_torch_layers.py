"""The port's layer primitives against the JAX package's, on the CPU:
norms, rotary embeddings, activations and softcap within 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import layers as jl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)


def rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("shape", [(3, 5, 64), (2, 1152)])
def test_apply_norm(shape):
    x, scale = rand(0, *shape), rand(1, shape[-1], scale=0.1)
    want = jl.apply_norm("rmsnorm", {"scale": jnp.asarray(scale)},
                         jnp.asarray(x))
    got = tl.apply_norm("rmsnorm", torch.from_numpy(x),
                        torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_unported_norm_and_activation_raise():
    """layernorm and gelu_mlp are ported (tests/test_torch_encdec.py); a
    kind neither package has raises."""
    x = torch.zeros(2, 4)
    with pytest.raises(NotImplementedError):
        tl.apply_norm("batchnorm", x, torch.zeros(4))
    with pytest.raises(NotImplementedError):
        tl.activation("relu", x)


def test_norm_module_is_gemma_style():
    norm = tl.Norm("rmsnorm", 16, torch.float32, torch.device("cpu"))
    assert torch.count_nonzero(norm.scale) == 0      # (1 + 0) scale at init
    x = torch.from_numpy(rand(3, 2, 16))
    torch.testing.assert_close(norm(x), x * torch.rsqrt(
        x.square().mean(-1, keepdim=True) + 1e-6))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope(theta):
    x = rand(4, 2, 7, 3, 32)                           # (B, S, H, D)
    pos = np.array([[0, 1, 2, 3, 4, 5, 6], [9, 100, 511, 512, 700, 701, 0]],
                   np.int32)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("scale", [1.0, 3.0])
@pytest.mark.parametrize("name", ["gelu", "silu"])
def test_activation(name, scale):
    x = rand(5, 4, 33, scale=scale)
    want = jl.activation(name, jnp.asarray(x))
    got = tl.activation(name, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tl.gated(name) == jl.gated(name)


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_softcap(cap):
    x = rand(6, 5, 17, scale=40.0)
    want = jl.softcap(jnp.asarray(x), cap)
    got = tl.softcap(torch.from_numpy(x), cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

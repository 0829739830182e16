"""ops/backend.py: the engine runs on the GPU or the CPU, and an
unsupported platform raises instead of falling back."""
import jax
import jax.numpy as jnp
import pytest

from gie_mapping_tpu.models.mapper import VolumetricMapper
from gie_mapping_tpu.ops import backend
from gie_mapping_tpu.ops.edt_batch import batch_edt
from gie_mapping_tpu.utils.config import scan2d_config


def test_cpu_is_supported():
    assert backend.platform() == "cpu"


def test_gpu_is_supported(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert backend.platform() == "gpu"


@pytest.mark.parametrize("name", ["rocm", "METAL", "neuron"])
def test_unsupported_platform_raises(monkeypatch, name):
    monkeypatch.setattr(jax, "default_backend", lambda: name)
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        backend.platform()


def test_default_device_decides_the_platform(monkeypatch):
    """Work placed on the CPU device of a GPU process is CPU work."""
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with jax.default_device(jax.devices("cpu")[0]):
        assert backend.platform() == "cpu"
    with jax.default_device("cpu"):
        assert backend.platform() == "cpu"


def test_entry_points_refuse_an_unsupported_platform(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        VolumetricMapper(scan2d_config(local_size_m=(1.6, 1.6, 0.8),
                                       voxel_width=0.2))
    jax.clear_caches()  # make batch_edt trace again
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        batch_edt(jnp.zeros((8, 8, 8), jnp.int8), max_width=24)
    monkeypatch.undo()
    jax.clear_caches()

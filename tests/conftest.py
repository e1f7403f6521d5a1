import jax
import pytest

# NOTE: no XLA_FLAGS here — smoke tests and benches must see 1 device
# (the 512-device override lives ONLY in launch/dryrun.py).

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "jaxpr_audit: ContractGuard layer-2 tests that trace live-server "
        "hot loops (CI runs them in the static-analysis job; the tp=2,ep=4 "
        "case additionally needs XLA_FLAGS="
        "--xla_force_host_platform_device_count=8)")
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU (the port's CUDA kernels); skips without "
        "one")


@pytest.fixture(scope="session")
def mesh1():
    from repro.distributed.ctx import local_mesh_ctx
    return local_mesh_ctx()

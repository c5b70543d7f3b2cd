"""How far the JAX package's f32 gradients of a small random-init MoE
model lie from its float64 ones, on a (2, 4) mesh of host devices.

    PYTHONPATH=src python tools/jax_f32_grad_error.py

The model, plan and batch are those of ``tests/test_step_overlap.py`` and
``tests/test_torch_step_overlap.py`` (4 layers, d_model 128, 8 experts,
ring plan with m = 1, capacity 16, 16 rows of 16 tokens).  Prints, for
every gradient leaf, max |g_f32 - g_f64| over max |g_f64|: the rounding
error either package's f32 gradient carries, against which the port is
held to the JAX package.  CPU only; it runs no port code.
"""
import os

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.common.compat import install_axis_type_shim  # noqa: E402

install_axis_type_shim()

from repro.common.config import ModelConfig, MoEConfig  # noqa: E402
from repro.core import moe as moe_core  # noqa: E402
from repro.core.placement import homogeneous_sharding  # noqa: E402
from repro.core.schedule import sparse_materialization  # noqa: E402
from repro.models import model as mdl  # noqa: E402
from repro.train import step as step_lib  # noqa: E402


def main():
    ep = 4
    mesh = jax.make_mesh((2, ep), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    toks = jnp.asarray(np.random.default_rng(0).integers(
        0, 512, (16, 17)).astype(np.int32))
    grads = {}
    for dt in ("float32", "float64"):
        cfg = ModelConfig(
            name="t", arch_type="moe", num_layers=4, d_model=128,
            num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256,
            vocab_size=512,
            moe=MoEConfig(num_experts=8, experts_per_token=2, d_ff=256,
                          slots_per_device=2),
            act="gelu", norm="ln", remat=False, dtype=dt, param_dtype=dt)
        L = moe_core.num_moe_layers(cfg)
        pa = moe_core.plan_to_arrays(sparse_materialization(
            homogeneous_sharding(L, 8, ep), np.ones((L, 8)), t=4, m=1,
            impl="ring"))
        rt = mdl.Runtime(mesh=mesh, moe=moe_core.MoERuntime(
            mesh=mesh, batch_axes=("data",), impl="ring", m=1,
            capacity=16, use_pallas=False))
        p32 = mdl.init_params(cfg.replace(dtype="float32",
                                          param_dtype="float32"),
                              jax.random.PRNGKey(0), ep=ep)
        params = jax.tree.map(lambda a: a.astype(dt), p32)
        (loss, _), g = jax.jit(jax.value_and_grad(
            lambda p: step_lib.loss_fn(cfg, rt, p, {"tokens": toks}, pa),
            has_aux=True))(params)
        grads[dt] = g
        print(f"{dt} loss {float(loss):.10f}")
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(grads["float32"]),
            jax.tree_util.tree_leaves_with_path(grads["float64"])):
        err = float(jnp.abs(a - b).max() / jnp.abs(b).max())
        print(f"{jax.tree_util.keystr(path)}: {err:.3e}")


if __name__ == "__main__":
    main()

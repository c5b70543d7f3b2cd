"""How far the f32 results of Whisper's smoke config lie from float64 ones,
in the JAX package and in the port, on the CPU: the noise floor against
which ``tests/test_torch_whisper.py`` holds the port to the JAX package.

    PYTHONPATH=src python tools/whisper_f32_error.py

The inputs are the test's: the JAX registry's ``smoke()`` config (2 + 2
layers, d_model 256, 32 frames, vocabulary 512), ``PRNGKey(0)`` weights,
numpy seed 0 for the stand-in frames and the 2 x 17 tokens.  The float64
reference is the JAX package's own code run with x64 on, its f32 casts
(norm, RoPE, attention, unembedding, loss) turned to float64 in this
process.  Prints, for the logits and for every gradient leaf, the largest
|difference| over the largest |float64 value| of the JAX package's f32
result, of the port's, and between the two; then how far JAX's f32
results compiled whole (``jax.jit``, as the tests run its steps) lie
from its op-by-op ones, and the port from them; and how far a relative
perturbation of 1e-7 of the frames moves JAX's own f32 logits and
gradients.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jly  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.train import step as jst  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch.common.params import params_from_jax  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.train import step as st  # noqa: E402

ARCH = "whisper-medium"


class _Wide:
    """``jax.numpy`` with ``float32`` meaning float64."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _jax(cfg, params, batch, wide=False, jit=False):
    """(logits, gradient leaves by path) of the JAX package, op by op or
    (``jit``) compiled whole."""
    mods = (jattn, jly, jst)
    saved = [m.jnp for m in mods]
    if wide:
        for m in mods:
            m.jnp = _Wide()
    try:
        fwd = lambda p: jmdl.forward(  # noqa: E731
            cfg, jmdl.Runtime(), p, batch["tokens"][:, :-1],
            encoder_input=batch["encoder_input"])[0]
        grad = jax.value_and_grad(
            lambda p: jst.loss_fn(cfg, jmdl.Runtime(), p, batch, None),
            has_aux=True)
        if jit:
            fwd, grad = jax.jit(fwd), jax.jit(grad)
        logits = fwd(params)
        (_, _), g = grad(params)
    finally:
        for m, j in zip(mods, saved):
            m.jnp = j
    return np.asarray(logits, np.float64), {
        jax.tree_util.keystr(k): np.asarray(v, np.float64)
        for k, v in jax.tree_util.tree_leaves_with_path(g)}


def _port(cfg, np_params, batch):
    params = params_from_jax(np_params, "cpu")
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    with torch.no_grad():
        logits, _ = mdl.forward(cfg, mdl.Runtime(use_pallas=False), params,
                                tb["tokens"][:, :-1],
                                encoder_input=tb["encoder_input"])
    _, g = st.loss_and_grads(cfg, mdl.Runtime(use_pallas=False),
                             params_from_jax(np_params, "cpu"), tb, None)

    def flat(t, prefix=""):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from flat(t[k], f"{prefix}['{k}']")
        else:
            yield prefix, t.detach().numpy().astype(np.float64)
    return logits.numpy().astype(np.float64), dict(flat(g))


def _rel(a, ref):
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def main():
    jcfg, cfg = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
    p32 = jmdl.init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, p32)
    rng = np.random.default_rng(0)
    enc = rng.standard_normal((2, cfg.encoder_seq_len, cfg.d_model),
                              np.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks), "encoder_input": jnp.asarray(enc)}
    jl, jg = _jax(jcfg, p32, batch)
    tl, tg = _port(cfg, np_params, {"tokens": toks, "encoder_input": enc})
    cfg64 = jcfg.replace(dtype="float64", param_dtype="float64")
    wl, wg = _jax(cfg64, jax.tree.map(lambda a: a.astype(jnp.float64), p32),
                  {"tokens": batch["tokens"],
                   "encoder_input": batch["encoder_input"].astype(
                       jnp.float64)}, wide=True)
    print("relative to the largest |float64 value|: JAX f32, port f32, "
          "port against JAX")
    print(f"logits: {_rel(jl, wl):.3e} {_rel(tl, wl):.3e} "
          f"{_rel(tl, jl):.3e}")
    worst = [0.0, 0.0, 0.0]
    for k in sorted(wg):
        row = (_rel(jg[k], wg[k]), _rel(tg[k], wg[k]), _rel(tg[k], jg[k]))
        worst = [max(a, b) for a, b in zip(worst, row)]
        print(f"grad {k}: {row[0]:.3e} {row[1]:.3e} {row[2]:.3e}")
    print(f"grad, largest over the leaves: {worst[0]:.3e} {worst[1]:.3e} "
          f"{worst[2]:.3e}")
    cl, cg = _jax(jcfg, p32, batch, jit=True)
    print(f"JAX f32 compiled whole (jax.jit) against op by op: logits "
          f"{_rel(cl, jl):.3e}, gradients up to "
          f"{max(_rel(cg[k], jg[k]) for k in jg):.3e}; the port against "
          f"the compiled: logits {_rel(tl, cl):.3e}, gradients up to "
          f"{max(_rel(tg[k], cg[k]) for k in cg):.3e}")
    noisy = enc * (1 + 1e-7 * np.random.default_rng(1).standard_normal(
        enc.shape)).astype(np.float32)
    nl, ng = _jax(jcfg, p32, {"tokens": batch["tokens"],
                              "encoder_input": jnp.asarray(noisy)})
    print(f"JAX f32 moved by a 1e-7 perturbation of the frames: logits "
          f"{_rel(nl, jl):.3e}, gradients up to "
          f"{max(_rel(ng[k], jg[k]) for k in jg):.3e}")


if __name__ == "__main__":
    main()

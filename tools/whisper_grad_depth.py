"""How the gradient norm of Whisper's seeded random init grows with depth,
in the JAX package and in the port, on the CPU.

    PYTHONPATH=src python tools/whisper_grad_depth.py [--depths 2,4,8,24]

At the JAX registry's ``smoke()`` widths (d_model 256, 4 heads of 64, 32
frames, vocabulary 512, f32) cut or deepened to L encoder and L decoder
layers, ``PRNGKey(0)`` weights carried to the port, numpy seed 0 for 2
rows of 16 tokens and their stand-in frames: prints each package's loss,
f32 global gradient norm and largest gradient entry per depth.  Beyond
some depth the sum of squares of the gradient leaves (f32 at most ~3.4e38)
overflows, and both packages' step guards skip the step.
"""
import argparse
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.train import step as jst  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch.common.params import params_from_jax  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import step as st  # noqa: E402

ARCH = "whisper-medium"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--depths", default="2,4,8,12,16,24")
    args = ap.parse_args()
    rng = np.random.default_rng(0)
    print("L  loss (JAX, port)  f32 gradient norm (JAX, port)  largest "
          "|g| (JAX, port)")
    for n in (int(x) for x in args.depths.split(",")):
        jcfg = jconfigs.get_smoke(ARCH).replace(num_layers=n,
                                                encoder_layers=n)
        cfg = configs.get_smoke(ARCH).replace(num_layers=n,
                                              encoder_layers=n)
        jp = jmdl.init_params(jcfg, jax.random.PRNGKey(0))
        enc = rng.standard_normal((2, cfg.encoder_seq_len, cfg.d_model),
                                  np.float32)
        toks = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
        jb = {"tokens": jnp.asarray(toks), "encoder_input": jnp.asarray(enc)}
        (jl, _), jg = jax.jit(jax.value_and_grad(
            lambda p: jst.loss_fn(jcfg, jmdl.Runtime(), p, jb, None),
            has_aux=True))(jp)
        jleaves = jax.tree.leaves(jg)
        jn = float(jnp.sqrt(sum(jnp.sum(g.astype(jnp.float32) ** 2)
                                for g in jleaves)))
        jmax = max(float(jnp.abs(g).max()) for g in jleaves)
        tm, tg = st.loss_and_grads(
            cfg, mdl.Runtime(use_pallas=False),
            params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
            {"tokens": torch.from_numpy(toks),
             "encoder_input": torch.from_numpy(enc)}, None)
        tn = float(adamw.global_norm(tg))
        tmax = max(float(g.abs().max()) for g in adamw.leaves(tg))
        print(f"{n:2d}  {float(jl):.4f} {float(tm['loss']):.4f}  "
              f"{jn:.3e} {tn:.3e}  {jmax:.3e} {tmax:.3e}", flush=True)


if __name__ == "__main__":
    main()

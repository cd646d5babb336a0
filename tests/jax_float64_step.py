"""The JAX package's training step in float64: the exact answer that the
float32 training-step tests measure both packages against.

    python tests/jax_float64_step.py ol OUT.npz

runs ``torch_train_parity``'s float32 problem of the preset ("vil" or
"vil", "ol", "ms" or "v3") through ``jax_step`` with 64-bit types enabled and every float32
type the package names widened to float64: ``jnp.float32`` is rebound to
``jnp.float64`` before ``phnet_tpu`` (and flax) is imported, so module
defaults and casts take float64 too. No file of the package changes.
Writes the loss, the matches, the head's outputs and each gradient leaf
(the port's names) to ``OUT.npz``, in float64.

It runs in a process of its own: the 64-bit switch and the rebinding hold
for the whole interpreter, and the test processes have imported the
package in float32 already.
"""

import os
import sys


def main(preset: str, out: str) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_default_matmul_precision", "highest")
    import jax.numpy as jnp
    import numpy as np

    jnp.float32 = jnp.float64  # before phnet_tpu and flax are imported
    tests = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [tests, os.path.dirname(tests)]
    import torch_train_parity as ttp

    jc, tc, jl, _ = ttp.configs(preset)
    variables, frames, labels = ttp.problem(preset, tc)
    run = ttp.jax_step(jc, jl, variables, labels, dtype=np.float64)(frames)
    if run["outs"].pred_fir.dtype != jnp.float64:
        raise SystemExit(f"the JAX step ran in {run['outs'].pred_fir.dtype}")
    np.savez(out, loss=np.float64(run["loss"]), matches=run["matches"],
             **{f"out.{k}": np.asarray(getattr(run["outs"], k))
                for k in ("pred_fir", "pred_sec", "diff")},
             **{f"grad.{k}": g for k, g in run["grads"].items()})


if __name__ == "__main__":
    main(*sys.argv[1:])

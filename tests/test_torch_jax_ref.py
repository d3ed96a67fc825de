"""Helpers of the port's tests that compute a JAX reference once."""

import jax
import jax.numpy as jnp
import numpy as np

# a reference program runs once: its compile time is all it costs
CHEAP_XLA = {"xla_backend_optimization_level": 0,
             "xla_llvm_disable_expensive_passes": True}


def per_window(fn, batched_args, n):
    """``jax.vmap(fn)(*batched_args)`` over the first ``n`` windows, the
    cheap way for a reference: ``fn`` is compiled unbatched (faster to
    trace than the vmapped program) with XLA's cheap CPU backend options,
    run per window, and the results are stacked."""
    one = lambda b: jax.tree.map(lambda x: x[b], batched_args)
    run = jax.jit(fn).lower(*one(0)).compile(compiler_options=CHEAP_XLA)
    return jax.tree.map(lambda *x: jnp.stack(x),
                        *[run(*one(b)) for b in range(n)])


def to_numpy(x):
    """A JAX pytree of NamedTuples as nested dicts of numpy arrays (the
    input of the port's ``tree_from_numpy``)."""
    if hasattr(x, "_asdict"):
        return {k: to_numpy(v) for k, v in x._asdict().items()}
    return np.asarray(x)

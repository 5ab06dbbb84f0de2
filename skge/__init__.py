"""Drop-in `skge` namespace: reference user code runs unmodified.

The upstream package is imported as `skge` (scikit-kge's skge/__init__.py);
this shim maps that exact import surface onto the JAX implementation
(skge_tpu.compat class API + the host-side sample/param/actfun/util
modules), so

    from skge import HolE, PairwiseStochasticTrainer
    from skge import sample

works verbatim while training runs on the accelerator. See skge_tpu/compat.py for the
documented behavioral differences (pickle format, on-device epochs).
"""

from skge_tpu.compat import (
    Config,
    ERMLP,
    HolE,
    Model,
    PairwiseStochasticTrainer,
    RESCAL,
    StochasticTrainer,
    TransE,
)
from skge import actfun, base, param, sample, util  # noqa: E402

__all__ = [
    "Config",
    "Model",
    "TransE",
    "RESCAL",
    "HolE",
    "ERMLP",
    "StochasticTrainer",
    "PairwiseStochasticTrainer",
    "actfun",
    "base",
    "param",
    "sample",
    "util",
]

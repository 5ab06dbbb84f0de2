"""skge_tpu: a knowledge-graph-embedding framework in JAX.

A from-scratch JAX/XLA re-architecture of the capabilities of
unmeshvrije/scikit-kge (blueprint: SURVEY.md). Functional core:

    from skge_tpu import HolE, AdaGrad, training, sampling, evaluation

Reference-compatible class surface (skge-style Model/Trainer/Sampler API):

    from skge_tpu import compat
"""

from skge_tpu.models import (ERMLP, MODELS, ComplEx, ConvE, DistMult, HolE,
                             KGEModel, PairRE, QuatE, RESCAL, RotatE,
                             SimplE, TransE, TransH, TransR, TuckER)
from skge_tpu.optim import (OPTIMIZERS, SCHEDULES, AdaGrad, Adam, SGD,
                            Schedule, WarmupCosine, WarmupLinear,
                            make_schedule)
from skge_tpu.sampling import (
    SAMPLERS,
    BernoulliSampler,
    CorruptedSampler,
    LCWASampler,
    RandomModeSampler,
    SharedNegativeSampler,
)
from skge_tpu.outofcore import OutOfCoreTrainer
from skge_tpu.parallel.partitioned import PartitionedTrainer
from skge_tpu.serving import (
    LinkPredictor,
    StreamedLinkPredictor,
    top_k_candidates,
)
from skge_tpu.training import (
    TrainState,
    init_state,
    make_ce_step,
    make_sampled_ce_step,
    make_epoch_fn,
    make_pairwise_step,
    make_pointwise_step,
    make_selfadv_step,
)

__version__ = "0.1.0"

__all__ = [
    "KGEModel",
    "TransE",
    "RESCAL",
    "HolE",
    "ERMLP",
    "DistMult",
    "ComplEx",
    "RotatE",
    "TransH",
    "TransR",
    "TuckER",
    "SimplE",
    "QuatE",
    "PairRE",
    "ConvE",
    "MODELS",
    "AdaGrad",
    "Adam",
    "SGD",
    "OPTIMIZERS",
    "SCHEDULES",
    "Schedule",
    "WarmupCosine",
    "WarmupLinear",
    "make_schedule",
    "OutOfCoreTrainer",
    "PartitionedTrainer",
    "LinkPredictor",
    "StreamedLinkPredictor",
    "top_k_candidates",
    "RandomModeSampler",
    "LCWASampler",
    "BernoulliSampler",
    "CorruptedSampler",
    "SharedNegativeSampler",
    "SAMPLERS",
    "TrainState",
    "init_state",
    "make_ce_step",
    "make_sampled_ce_step",
    "make_pairwise_step",
    "make_pointwise_step",
    "make_selfadv_step",
    "make_epoch_fn",
    "__version__",
]

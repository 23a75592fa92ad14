"""fccf_pcr_tpu — a point-cloud registration framework in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
samsgood0310/FCCF-PCR (Chung, Hsieh, Hsu 2023): feature-consistent
coplane-pair correspondence- and fusion-based rigid registration.

Public API:
    FCCFParams, Capacities          — static configuration
    register_pair, make_register_fn — single/batched registration
    pre_downsample                  — CLI-level first VoxelGrid pass
                                      (raw-capacity in, max_points out)
    registration_errors             — RRE/RTE metrics
"""

from .config import Capacities, FCCFParams, TEST_CAPS
from .pipeline.metrics import registration_errors
from .pipeline.register import (
    RegistrationResult,
    make_register_fn,
    pre_downsample,
    register_pair,
)

__version__ = "0.2.0"

__all__ = [
    "Capacities",
    "FCCFParams",
    "TEST_CAPS",
    "RegistrationResult",
    "make_register_fn",
    "pre_downsample",
    "register_pair",
    "registration_errors",
    "__version__",
]

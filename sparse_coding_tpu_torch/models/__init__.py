"""Trainable signatures and inference dictionaries. Importing the package
registers every family under its JAX signature name and every
inference dict class for the artifact files."""

from sparse_coding_tpu_torch.models import learned_dict, sae, signatures  # noqa: F401
from sparse_coding_tpu_torch.models import (  # noqa: F401
    combination,
    direct_coef,
    ica,
    lista,
    nmf,
    pca,
    positive,
    rica,
    semilinear,
    topk,
)
from sparse_coding_tpu_torch.models.learned_dict import (  # noqa: F401
    AddedNoise,
    Identity,
    IdentityPositive,
    IdentityReLU,
    LearnedDict,
    RandomDict,
    ReverseSAE,
    Rotation,
    TiedCenteredSAE,
    TiedSAE,
    TopKLearnedDict,
    UntiedSAE,
)
from sparse_coding_tpu_torch.models.sae import (  # noqa: F401
    FunctionalMaskedSAE,
    FunctionalMaskedTiedSAE,
    FunctionalReverseSAE,
    FunctionalSAE,
    FunctionalThresholdingSAE,
    FunctionalTiedCenteredSAE,
    FunctionalTiedSAE,
    ThresholdingSAE,
)
from sparse_coding_tpu_torch.models.topk import TopKEncoder  # noqa: F401

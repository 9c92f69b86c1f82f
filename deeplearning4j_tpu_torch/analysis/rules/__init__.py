"""graftlint rule registry — one module per bug-class family.

Every rule encodes a defect the reference shipped (the historical note
on each Rule subclass names it). Adding a rule: subclass
`analysis.core.Rule`, register it in ALL_RULES here, add a
positive+negative fixture pair under tests/fixtures/torch_graftlint/
(and a jax-profile pair beside the reference's), say under which
profiles it applies (`Rule.not_applicable`), and document it in
README.md's section on the port's analyzer.
"""
from deeplearning4j_tpu_torch.analysis.rules.donation import DonatedAliasingRule
from deeplearning4j_tpu_torch.analysis.rules.envknobs import EnvKnobContractRule
from deeplearning4j_tpu_torch.analysis.rules.excepts import BareExceptSwallowRule
from deeplearning4j_tpu_torch.analysis.rules.hotpath import (
    HostSyncInHotPathRule, RecompileHazardRule,
)
from deeplearning4j_tpu_torch.analysis.rules.locks import BlockingUnderLockRule
from deeplearning4j_tpu_torch.analysis.rules.lockorder import (
    LockOrderInversionRule, TransitiveBlockingUnderLockRule,
)
from deeplearning4j_tpu_torch.analysis.rules.pairing import ResourcePairingRule
from deeplearning4j_tpu_torch.analysis.rules.restore import (
    UnlaunderedRestorePlacementRule,
)
from deeplearning4j_tpu_torch.analysis.rules.telemetry import (
    MetricFamilyRegistrationRule, TelemetryZeroCostRule,
)
from deeplearning4j_tpu_torch.analysis.rules.threads import ThreadLifecycleRule

ALL_RULES = [
    DonatedAliasingRule(),
    UnlaunderedRestorePlacementRule(),
    HostSyncInHotPathRule(),
    RecompileHazardRule(),
    EnvKnobContractRule(),
    BlockingUnderLockRule(),
    LockOrderInversionRule(),
    TransitiveBlockingUnderLockRule(),
    ThreadLifecycleRule(),
    ResourcePairingRule(),
    TelemetryZeroCostRule(),
    BareExceptSwallowRule(),
    MetricFamilyRegistrationRule(),
]

__all__ = ["ALL_RULES"]

"""The continuous-learning flywheel, the port's copy of
``kubetorch_tpu/flywheel/``: serve -> collect -> train -> publish ->
canary -> promote, as one crash-safe loop on harvested capacity.

- :mod:`.ledger`: the durable feedback ledger. Content-hashed segments in
  (:func:`engine_feedback_hook` on a ``GenerationEngine``'s
  ``feedback_sink``), at-least-once batches deduplicated by hash out, the
  cursor committed under the trainer's own checkpoint.
- :mod:`.harvester`: batch-tier harvest and vacate on serving-trough
  capacity, vacating inside ``drain_grace_s`` through the drain contract
  (``serving/elastic.py``).
- :mod:`.promoter`: the eval gate, then the port's ``CanaryRollout`` over
  ``publish_rollout``: promote, or a typed rollback.

Every store access takes an explicit ``store`` (``data_store/commands.py``
has the protocol). Keys, record hashes and cursor states are the JAX
package's, so either package's trainer reads the other's ledger.
"""

from .harvester import (HARVEST, IDLE, VACATE, Harvester, HarvestPolicy,
                        harvest_record)
from .ledger import (FeedbackLedger, LedgerCursor, engine_feedback_hook,
                     read_all_hashes, record_hash)
from .promoter import (BREAK_ENV, BREAK_PROMOTE_BAD, GATE_REJECTED,
                       PROMOTED, ROLLED_BACK, Promoter, flywheel_status)

__all__ = [
    "FeedbackLedger", "LedgerCursor", "engine_feedback_hook",
    "read_all_hashes", "record_hash",
    "Harvester", "HarvestPolicy", "harvest_record",
    "HARVEST", "VACATE", "IDLE",
    "Promoter", "flywheel_status",
    "BREAK_ENV", "BREAK_PROMOTE_BAD",
    "GATE_REJECTED", "PROMOTED", "ROLLED_BACK",
]

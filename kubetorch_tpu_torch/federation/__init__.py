"""The federation pieces the port's stores and checkpoint need: the store
topology (``topology.py``) and the cross-region tier (``replication.py``:
``XRegionReplicator``, which pushes each region's writes to the others,
and the fallback read of a commit marker)."""

from .replication import XRegionReplicator, fallback_commit

__all__ = ["XRegionReplicator", "fallback_commit"]

"""The swarm protocol: aggregation, the QSGD wire, audits, the ledger and
the round engine.  Import the submodules directly (``repro_torch.core.swarm``)."""

"""Checkpoints: full param trees and custody-sharded Protocol-Model
checkpoints.  Import the submodule directly (``repro_torch.checkpoint.checkpoint``)."""

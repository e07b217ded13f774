"""Protocol Model server (paper §4.1): credential-gated, custody-sharded
inference (twin of ``repro/core/protocol.py``).

Weights live only as custody shards across participants; a request is
served by reassembling the params transiently from the shards of the
online nodes, which by construction needs the whole swarm; callers get
logits, never weights; access requires ledger credentials.

Serving is cached per online-node set: the reassembled params are built
once per distinct set of live custody holders and reused while that set
recurs, in a small LRU (heavy churn evicts the oldest sets).  The
reference jits ``Model.prefill``; here it is a plain call under
``torch.inference_mode()``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from repro_torch.core import serving
from repro_torch.core.ledger import Ledger
from repro_torch.core.unextractable import ShardCustody, reconstruct_params, shard_params
from repro_torch.models.convert import Layout, layout_of

Params = Dict[str, torch.Tensor]


class ExtractionError(PermissionError):
    pass


class CredentialError(PermissionError):
    pass


@dataclass
class ProtocolModelServer:
    """Inference only within the protocol; weights never leave it."""

    model: object                        # repro_torch.models.model.Model
    custody: ShardCustody
    ledger: Ledger
    _shards: Dict[str, Dict[int, torch.Tensor]] = field(
        default_factory=dict, repr=False)    # node -> {shard_id: data}
    _template: Optional[Layout] = field(default=None, repr=False)
    _true_size: int = 0
    _device: Optional[torch.device] = None
    #: reassembled params per frozenset of online nodes (LRU-bounded: each
    #: entry is a full set of weights)
    _params_cache: Dict[frozenset, Params] = field(default_factory=dict, repr=False)
    cache_size: int = 8

    @classmethod
    def create(cls, model, params: Params, nodes: List[str], ledger: Ledger, *,
               num_shards: int = 16, redundancy: int = 2, seed: int = 0,
               max_fraction: float = 0.5) -> "ProtocolModelServer":
        custody = ShardCustody.assign(nodes, num_shards, redundancy, seed, max_fraction)
        shards, true_size = shard_params(params, num_shards)
        per_node: Dict[str, Dict[int, torch.Tensor]] = {n: {} for n in nodes}
        for sid, holders in custody.assignment.items():
            for h in holders:
                per_node[h][sid] = shards[sid]
        srv = cls(model=model, custody=custody, ledger=ledger)
        srv._shards = per_node
        srv._template = layout_of(params)
        srv._true_size = true_size
        srv._device = shards[0].device
        return srv

    # -- protocol-side reassembly ------------------------------------------------
    def _gather(self, nodes: List[str]) -> Dict[int, torch.Tensor]:
        gathered: Dict[int, torch.Tensor] = {}
        for n in nodes:
            gathered.update(self._shards.get(n, {}))
        return gathered

    def _params_for(self, nodes: List[str]) -> Params:
        """Reassembled params for this online-node set, cached on the set
        (order-free).  Raises with the missing shard ids when the set
        cannot cover the model."""
        key = frozenset(nodes)
        if key in self._params_cache:
            self._params_cache[key] = self._params_cache.pop(key)  # LRU bump
            return self._params_cache[key]
        gathered = self._gather(nodes)
        if len(gathered) < self.custody.num_shards:
            missing = self.custody.missing_shards(nodes)
            raise ExtractionError(
                f"swarm incomplete: {len(gathered)}/{self.custody.num_shards} "
                f"shards online, missing shard ids {missing}")
        while len(self._params_cache) >= max(1, self.cache_size):
            self._params_cache.pop(next(iter(self._params_cache)))
        params = reconstruct_params(gathered, self._template, self.custody.num_shards,
                                    self._true_size)
        self._params_cache[key] = params
        return params

    # -- the only public capability: logits ------------------------------------
    def _online(self, holder: str, online_nodes: Optional[List[str]]) -> List[str]:
        if not self.ledger.can_infer(holder):
            raise CredentialError(f"{holder} holds no credentials")
        return online_nodes if online_nodes is not None else list(self._shards)

    def serve(self, holder: str, batch, *,
              online_nodes: Optional[List[str]] = None) -> torch.Tensor:
        """Last-position logits (B, V) of ``Model.prefill`` on the batch."""
        params = self._params_for(self._online(holder, online_nodes))
        with torch.inference_mode():
            return self.model.prefill(params, batch)

    def decode(self, holder: str, prompts: torch.Tensor, max_new: int, *,
               online_nodes: Optional[List[str]] = None):
        """Credential-gated batched greedy decoding
        (``core.serving.greedy_decode``): (B, max_new) tokens and stats."""
        params = self._params_for(self._online(holder, online_nodes))
        return serving.greedy_decode(self.model, params, prompts, max_new)

    # -- what an attacker coalition gets ----------------------------------------
    def attempt_extraction(self, coalition: List[str]) -> Params:
        """The (broken) params a coalition can reassemble: unusable below
        full coverage."""
        gathered = self._gather(coalition)
        if len(gathered) >= self.custody.num_shards:
            raise ExtractionError(
                "coalition covers the full model — custody bound violated; "
                "this configuration is NOT a Protocol Model")
        return reconstruct_params(gathered, self._template, self.custody.num_shards,
                                  self._true_size, device=self._device)

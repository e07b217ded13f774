"""The launchers on the CPU, at 2-4 rounds: ``launch/swarm.py --scenario``
on a decentralized scenario and on ``stale_poisoning`` (the async round,
with the custody checkpoint at the end restored bit for bit by every
holder and refused to two), ``launch/derailment_no_off.py`` (the small
LM's three-regime table), ``launch/topology_no_off.py --tiny`` (the
decentralized table on the quadratic, with its spectral gaps) and
``launch/custody_frontier.py --tiny`` (its extractability table equal to
the reference example's grid swept by the reference: the letters read
coverage alone), ``launch/serve.py --driver engine`` and
``launch/serving_no_off.py --smoke`` (its table equal to the reference
example's).  Their refusal of the CPU unless asked is in
``test_torch_package.py``."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import derailment as jder
from repro.core import scenarios as jscen
from repro.core import serving as jserving
from repro.models.model import build_model as jbuild_model
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.launch import custody_frontier as launch_custody
from repro_torch.launch import derailment_no_off as launch_derailment
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import serving_no_off as launch_serving
from repro_torch.launch import swarm as launch_swarm
from repro_torch.launch import topology_no_off as launch_topology

from test_torch_decentralized import one_thread  # noqa: F401


def test_swarm_launcher_runs_a_decentralized_scenario_on_the_cpu(capsys):
    """``--scenario`` with a topology: per-node replicas, the loss column
    on the consensus replica, the ledger conserved; never fused on the
    CPU."""
    out = launch_swarm.main(["--device", "cpu", "--rounds", "2", "--scenario",
                             "byzantine_neighborhood", "--nodes", "8"])
    swarm = out["swarm"]
    assert not swarm.fused and len(out["nodes"]) == 8
    assert swarm.params["embed"].shape[0] == 8
    assert all(np.isfinite(out["losses"])) and swarm.ledger.check_conservation()
    assert all(h["consensus_error"] > 0 for h in swarm.history)
    assert "scenario: byzantine_neighborhood (8 nodes" in capsys.readouterr().out


def test_phase_diagram_launchers_run_on_the_cpu_when_asked(capsys):
    """The two §5.5 launchers at 2 rounds: the small LM's three-regime
    table, and the decentralized table on the quadratic with its spectral
    gaps."""
    res = launch_derailment.main(["--device", "cpu", "--rounds", "2"])
    assert res.n_runs == 10 and len(res.results) == 9
    assert all(np.isfinite(r.init_loss) for r in res.results)
    text = capsys.readouterr().out
    assert "mean+verified" in text and "attack economics" in text
    res = launch_topology.main(["--device", "cpu", "--rounds", "2", "--tiny", "--seeds", "1"])
    assert res.n_runs == 24 + 4 and {r.topology for r in res.results} == set(
        launch_topology.TOPOLOGIES)
    text = capsys.readouterr().out
    assert "ring             gap=" in text and "centered_clip@clustered" in text


def test_swarm_launcher_refuses_nodes_with_the_showcase(capsys):
    """``--nodes`` sizes a registered scenario; with the showcase's fixed
    10-node roster it is a usage error, not a silent no-op."""
    with pytest.raises(SystemExit) as exc:
        launch_swarm.main(["--device", "cpu", "--rounds", "1", "--nodes", "16"])
    assert exc.value.code == 2
    assert "--nodes sizes a registered --scenario" in capsys.readouterr().err


def test_swarm_launcher_runs_an_async_scenario_and_checkpoints(capsys, tmp_path):
    """``--scenario stale_poisoning``: the async round (staleness above 0
    once the ring has rounds to lag), only the attackers slashed; the
    custody checkpoint restored by every holder equals the params bit for
    bit, and two holders are refused."""
    out = launch_swarm.main(["--device", "cpu", "--rounds", "3", "--scenario",
                             "stale_poisoning", "--nodes", "8", "--ckpt", str(tmp_path)])
    swarm = out["swarm"]
    assert swarm.cfg.staleness_bound == 3 and swarm._ring is not None
    assert max(h["staleness"] for h in swarm.history) > 0
    assert swarm.slashed <= {"adv0", "adv1"} and swarm.ledger.check_conservation()
    holders = [n for shard in out["custody"].assignment.values() for n in shard]
    back = ckpt.restore_custody(out["ckpt"], swarm.eval_params(), holders=sorted(set(holders)))
    for k, v in swarm.eval_params().items():
        assert torch.equal(back[k].view(torch.int32), v.view(torch.int32)), k
    with pytest.raises(PermissionError):
        ckpt.restore_custody(out["ckpt"], swarm.eval_params(), holders=holders[:2])
    assert "partial-coalition restore correctly refused" in capsys.readouterr().out


def test_custody_frontier_launcher_table_equals_the_reference(capsys):
    from test_torch_derailment import _examples_common
    res = launch_custody.main(["--device", "cpu", "--tiny", "--rounds", "4", "--seeds", "1"])
    grid = launch_custody.custody_grid(4, 1)
    jgrid = jscen.SweepGrid(**{f: getattr(grid, f) for f in grid.__dataclass_fields__
                               if f != "regimes"},
                            regimes=(jscen.Regime("mean", "mean"),))
    jl, jp, jd, je, jo = _examples_common().tiny_quadratic_problem()
    jres = jder.sweep(jl, jp, jo, jd, je, jgrid)
    assert res.extractability_table() == jres.extractability_table()
    assert res.n_runs == jres.n_runs == 16
    text = capsys.readouterr().out
    assert "redundancy 3: min extraction coalition" in text and "mean r=3" in text


def test_serving_launchers_run_the_engine_on_the_cpu(capsys):
    """``launch/serve.py --driver engine`` serves every request of its
    queue; ``launch/serving_no_off.py --smoke`` renders the reference
    example's table (with no EOS the schedule, and so each cell, depends on
    the lane alone, not on the weights)."""
    out = launch_serve.main(["--device", "cpu", "--driver", "engine", "--batch", "6",
                             "--slots", "3", "--prompt-len", "5", "--max-new", "4"])
    res = out["result"]
    assert res.done.all() and res.tokens_served == 6 * 4 and res.availability == 1.0
    assert int(res.n_active.max()) == 3
    assert "engine slots=3 requests=6 served=6" in capsys.readouterr().out
    got = launch_serving.main(["--device", "cpu", "--smoke"])["serving_smoke"]
    jcfg = jget_config("protocol-125m").reduced(**launch_serving.MODEL)
    jmodel = jbuild_model(jcfg)
    want = jserving.sweep(jmodel, jmodel.init(jax.random.PRNGKey(0)),
                          jscen.get_serving_grid("serving_smoke"))
    assert got.availability_table() == want.availability_table()
    assert got.n_runs == 8 and "H a=0.50" in capsys.readouterr().out

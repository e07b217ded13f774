"""The three launchers of the decentralized slice on the CPU, at 2 rounds:
``launch/swarm.py --scenario`` on a decentralized scenario,
``launch/derailment_no_off.py`` (the small LM's three-regime table) and
``launch/topology_no_off.py --tiny`` (the decentralized table on the
quadratic, with its spectral gaps).  Their refusal of the CPU unless asked
is in ``test_torch_package.py``."""
import numpy as np
import pytest

from repro_torch.launch import derailment_no_off as launch_derailment
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

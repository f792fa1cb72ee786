"""The host's and the card's readings around a window, over a fake sysfs
tree, a fake ``nvidia-smi`` and ``/proc``."""

import subprocess
import types

import pytest

from harness import host

BUS = "0000:bb:00.0"


def sysfs(tmp_path, nodes, card_node, cpulists=None):
    """A sysfs tree: ``nodes`` NUMA nodes, the card on ``card_node``
    (None: no numa_node file)."""
    dev = tmp_path / "bus" / "pci" / "devices" / BUS
    dev.mkdir(parents=True)
    if card_node is not None:
        (dev / "numa_node").write_text(f"{card_node}\n")
    for n in range(nodes):
        d = tmp_path / "devices" / "system" / "node" / f"node{n}"
        d.mkdir(parents=True)
        (d / "cpulist").write_text((cpulists or {}).get(n, f"{4 * n}-"
                                                        f"{4 * n + 3}\n"))
    return tmp_path


def test_the_card_on_one_of_two_nodes(tmp_path):
    root = sysfs(tmp_path, 2, 1, {1: "8-15,24-31\n"})
    assert host.card_numa(BUS, root) == \
        f"card {BUS}: NUMA node 1 of 2, its CPUs 8-15,24-31"


@pytest.mark.parametrize("nodes,card_node,says", [
    (1, 0, "NUMA node 0 of 1, its CPUs 0-3"),
    (0, -1, "no NUMA node (numa_node -1); 0 node(s)"),
    (2, None, "NUMA node unknown (FileNotFoundError"),
])
def test_what_a_host_without_a_clear_node_says(tmp_path, nodes, card_node,
                                               says):
    assert says in host.card_numa(BUS, sysfs(tmp_path, nodes, card_node))


def test_a_host_without_sysfs(tmp_path):
    assert "NUMA node unknown" in host.card_numa(BUS, tmp_path / "none")


def test_cpulist():
    assert host.cpulist({0, 1, 2, 5, 7, 8}) == "0-2,5,7-8"
    assert host.cpulist([3]) == "3"
    assert host.cpulist([]) == ""


def fake_smi(stdout, rc=0):
    def run(cmd, **kw):
        assert cmd[0] == "nvidia-smi" and cmd[-2:] == ["-i", "0"]
        return types.SimpleNamespace(stdout=stdout, stderr="", returncode=rc)
    return run


def test_card_state_names_each_reading():
    s = host.card_state(0, fake_smi(
        "1980 MHz, 2619 MHz, 121.40 W, 36, 0x0000000000000000\n"))
    assert s == ("clocks.sm 1980 MHz, clocks.mem 2619 MHz, power.draw "
                 "121.40 W, temperature.gpu 36, "
                 "clocks_throttle_reasons.active 0x0000000000000000")


def test_card_state_without_a_reading():
    assert host.card_state(0, fake_smi("", rc=9)).startswith(
        "unread (nvidia-smi rc 9")

    def missing(cmd, **kw):
        raise FileNotFoundError(cmd[0])
    assert host.card_state(0, missing) == "unread (FileNotFoundError)"

    def slow(cmd, **kw):
        raise subprocess.TimeoutExpired(cmd, 20)
    assert host.card_state(0, slow) == "unread (TimeoutExpired)"


def test_thread_state_and_the_window_note():
    before = host.thread_state()
    after = host.thread_state()
    assert set(before) >= {"allowed", "cpu", "threads_on"}
    note = host.window_note(before, after)
    assert note.startswith("host over the window: CPUs allowed")
    if "nonvoluntary" in before:
        assert after["nonvoluntary"] >= before["nonvoluntary"]
        assert "nonvoluntary context switches" in note


def test_thread_state_from_a_fake_proc(tmp_path):
    stat = "7 (py thon) S " + " ".join(["0"] * 35) + " 5 0 0\n"
    me = tmp_path / "thread-self"
    me.mkdir()
    (me / "stat").write_text(stat)
    (me / "status").write_text("Name:\tpython\nvoluntary_ctxt_switches:\t"
                               "12\nnonvoluntary_ctxt_switches:\t3\n")
    for tid, cpu in ((7, 5), (8, 2)):
        d = tmp_path / "self" / "task" / str(tid)
        d.mkdir(parents=True)
        (d / "stat").write_text(stat.replace(" 5 0 0", f" {cpu} 0 0"))
    st = host.thread_state(tmp_path)
    assert st["cpu"] == 5 and st["threads_on"] == "2,5"
    assert st["voluntary"] == 12 and st["nonvoluntary"] == 3

"""The port's resource group admission on the CPU (InternalResourceGroup
semantics): the reference's file (tests/test_resource_groups.py)
carried over to `trino_tpu_torch` — concurrency limit and queue,
queue-full rejection, selectors and sub-groups, the coordinator's
`/v1/resourceGroup` endpoint — and seeded admission sequences held to
the reference's: the same submissions and completions start the same
queries in the same order, reject the same ones, and leave the same
counters."""

import threading
import time

import pytest

from trino_tpu_torch.server.resourcegroups import (QueryQueueFullError,
                                                   ResourceGroupConfig,
                                                   ResourceGroupManager,
                                                   Selector)


def test_concurrency_limit_and_queue():
    rgm = ResourceGroupManager(
        ResourceGroupConfig("root", hard_concurrency_limit=1,
                            max_queued=10))
    order = []
    release = threading.Event()

    def slow():
        order.append("first-started")

    def queued():
        order.append("second-started")

    rgm.submit("u", slow)          # runs immediately, holds the slot
    rgm.submit("u", queued)        # must queue
    assert order == ["first-started"]
    assert rgm.info()[0]["queued"] == 1
    nxt = rgm.finished("root")
    assert nxt is not None
    nxt()
    assert order == ["first-started", "second-started"]


def test_queue_full_rejects():
    rgm = ResourceGroupManager(
        ResourceGroupConfig("root", hard_concurrency_limit=1,
                            max_queued=1))
    rgm.submit("u", lambda: None)       # occupies the slot
    rgm.submit("u", lambda: None)       # queues
    with pytest.raises(QueryQueueFullError):
        rgm.submit("u", lambda: None)


def test_selectors_and_subgroups():
    rgm = ResourceGroupManager(
        ResourceGroupConfig("root", hard_concurrency_limit=10,
                            sub_groups=(
                                ResourceGroupConfig(
                                    "etl", hard_concurrency_limit=1),
                                ResourceGroupConfig(
                                    "adhoc", hard_concurrency_limit=2))),
        selectors=[Selector("etl_.*", "root.etl"),
                   Selector(".*", "root.adhoc")])
    assert rgm.select("etl_nightly").path == "root.etl"
    assert rgm.select("alice").path == "root.adhoc"
    # parent accounting: etl admission consumes root headroom too
    rgm.submit("etl_nightly", lambda: None)
    info = {g["group"]: g for g in rgm.info()}
    assert info["root.etl"]["running"] == 1
    assert info["root"]["running"] == 1


def test_coordinator_resource_group_endpoint():
    from trino_tpu_torch.client.client import Client
    from trino_tpu_torch.exec.session import Session
    from trino_tpu_torch.server.coordinator import CoordinatorServer
    coord = CoordinatorServer(
        Session(default_schema="tiny", device="cpu")).start()
    try:
        client = Client(coord.uri, user="rg")
        client.execute("SELECT 1")
        import json
        from urllib.request import urlopen
        with urlopen(f"{coord.uri}/v1/resourceGroup", timeout=5) as r:
            info = json.loads(r.read())
        assert info[0]["group"] == "root"
        assert info[0]["totalAdmitted"] >= 1
    finally:
        coord.stop()


# ---------------------------------------------------------------------------
# parity with the reference on the same admission sequences
# ---------------------------------------------------------------------------

def _admission_trail(mod, seed):
    import random
    rng = random.Random(seed)
    rgm = mod.ResourceGroupManager(
        mod.ResourceGroupConfig(
            "root", hard_concurrency_limit=3, max_queued=4,
            sub_groups=(mod.ResourceGroupConfig(
                            "etl", hard_concurrency_limit=1, max_queued=2),
                        mod.ResourceGroupConfig(
                            "adhoc", hard_concurrency_limit=2))),
        selectors=[mod.Selector("etl_.*", "root.etl"),
                   mod.Selector(".*", "root.adhoc")])
    started, trail = [], []
    for i in range(50):
        user = rng.choice(["etl_nightly", "etl_hourly", "alice", "bob"])
        if rng.random() < 0.7:
            try:
                rgm.submit(user, lambda i=i: started.append(i))
                trail.append(("submit", user, "ok"))
            except mod.QueryQueueFullError:
                trail.append(("submit", user, "full"))
        else:
            nxt = rgm.finished(rgm.select(user).path)
            trail.append(("finish", user, nxt is not None))
            if nxt is not None:
                nxt()
        trail.append(sorted((g["group"], g["running"], g["queued"],
                             g["totalAdmitted"]) for g in rgm.info()))
    return started, trail


@pytest.mark.parametrize("seed", range(4))
def test_admission_sequence_equals_reference(seed):
    import trino_tpu.server.resourcegroups as jax_rg
    import trino_tpu_torch.server.resourcegroups as port_rg
    port = _admission_trail(port_rg, seed)
    assert any(t[2] == "full" for t in port[1][::2]), \
        "every seed reaches the queue-full path"
    assert port == _admission_trail(jax_rg, seed)

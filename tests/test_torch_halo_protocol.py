"""K8's cross-process protocol on the CPU, with no jax and no card: the
flag words and slots of a rank's exported buffer, the epoch arithmetic,
each rank's plan (what it publishes, where each of its shards pulls
from) and ``halo_dma.exchange_emulation``, which replays publish, wait,
pull and consumed on integer-tagged slots under seeded random
interleavings of every rank's blocks.  On every mesh and rank layout the
sharded decode uses: every pull reads exactly the epoch it waited for, no
publish overwrites a slot before its reader is done with it, every
schedule terminates (the waits form a chain along "time") and t = 0
reads zeros.  The same checks catch a single slot and a missing reuse
wait.  The kernel itself is held against its plain version on the card
in test_torch_cuda.py."""

import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from rub_mimo_tpu_torch.kernels import halo_dma as k8
from rub_mimo_tpu_torch.parallel.multiprocess import CountHostSyncs

CU = (Path(k8.__file__).parent / "csrc" / "halo_dma.cu").read_text()


def column(n_time: int, per: int) -> list:
    """The "time" column's ranks, ``per`` shards a rank, rank-major."""
    return [[t // per] for t in range(n_time)]


def rows_of(n_time: int, n_sc: int, rows_per: int) -> list:
    """A [n_time][n_sc] mesh's ranks, each rank ``rows_per`` whole rows."""
    return [[t // rows_per] * n_sc for t in range(n_time)]


# the layouts of the sharded decode across processes: the (4, 1) mesh as
# 4 x 1 and 2 x 2 ranks, the (2, 2) mesh's column (and the whole (2, 2)
# mesh, one row a rank), the (8, 1) mesh as 8, 4 and 2 ranks
LAYOUTS = {
    "4x1_mesh_4_ranks": column(4, 1),
    "4x1_mesh_2_ranks": column(4, 2),
    "2x2_mesh_column": column(2, 1),
    "2x2_mesh_whole": rows_of(2, 2, 1),
    "8x1_mesh_8_ranks": column(8, 1),
    "8x1_mesh_4_ranks": column(8, 2),
    "8x1_mesh_2_ranks": column(8, 4),
}
EPOCHS = 7  # every slot reused three times


def expected(e: int, t: int, s: int) -> tuple:
    return ("zeros",) if t == 0 else (e, t - 1, s)


def check(em, ranks, epochs: int, blocks: int) -> None:
    n_ranks = 1 + max(r for row in ranks for r in row)
    assert em.overwrites == []
    want = {(ranks[t][s], e, t, s) for e in range(1, epochs + 1)
            for t in range(len(ranks)) for s in range(len(ranks[t]))}
    assert set(em.reads) == want
    for (r, e, t, s), tags in em.reads.items():
        assert tags == [expected(e, t, s)] * blocks, (r, e, t, s)
    assert n_ranks >= 1 and em.steps > 0


# ------------------------------------------------------------ pure parts
@pytest.mark.parametrize("epoch,slot,reuse", [
    (1, 1, 0), (2, 0, 0), (3, 1, 1), (4, 0, 2), (5, 1, 3), (1000, 0, 998),
    (2 ** 40 + 1, 1, 2 ** 40 - 1)])
def test_epoch_arithmetic(epoch, slot, reuse):
    assert k8.slot_of(epoch) == slot
    assert k8.reuse_epoch(epoch) == reuse
    # the epoch that last wrote this slot is the one whose pull is awaited
    if epoch > 2:
        assert k8.slot_of(reuse) == slot


@pytest.mark.parametrize("fn", [k8.slot_of, k8.reuse_epoch])
def test_epochs_start_at_one(fn):
    with pytest.raises(ValueError):
        fn(0)


@pytest.mark.parametrize("n_pub", [0, 1, 2, 64])
def test_buffer_layout(n_pub):
    lay = k8.buffer_layout(n_pub, 2, 2047)
    assert lay.flag_bytes == k8.FLAG_WORDS * 8 == 2048
    assert lay.halo_bytes == 2 * 2047 * 8
    assert lay.total_bytes == 2048 + 2 * n_pub * lay.halo_bytes
    spans = [(lay.halo(e, p), lay.halo(e, p) + lay.halo_bytes)
             for e in (1, 2) for p in range(n_pub)]
    spans.sort()
    for (a0, a1), (b0, _) in zip(spans, spans[1:]):
        assert a1 <= b0  # no two halos overlap
    for a0, a1 in spans:
        assert a0 >= lay.flag_bytes and a1 <= lay.total_bytes
        assert a0 % 8 == 0  # float2 loads and stores
    if n_pub:
        assert lay.halo(1, 0) == lay.halo(3, 0) != lay.halo(2, 0)


def test_flag_words_do_not_collide():
    lay = k8.buffer_layout(k8.MAX_SHARDS, 2, 2047)
    count = {lay.word(k8.PUBLISH_COUNT_WORD)}
    arrived = {lay.word(k8.ARRIVED_WORD + k) for k in range(k8.MAX_SHARDS)}
    consumed = {lay.word(k8.CONSUMED_WORD + p)
                for p in range(k8.MAX_SHARDS)}
    pulls = {lay.word(k8.PULL_COUNT_WORD + k)
             for k in range(k8.MAX_SHARDS)}
    groups = [count, arrived, consumed, pulls]
    assert sum(map(len, groups)) == len(set().union(*groups))
    # the publish counter on a 128-byte line of its own
    lines = [{w // 128 for w in g} for g in groups]
    assert lines[0].isdisjoint(lines[1] | lines[2] | lines[3])
    assert max(max(g) for g in groups) < lay.flag_bytes
    # a wait word released by the watchdog compares >= any epoch, as 64
    # bits and in its low 32 bits (the front end's cyclic comparison)
    assert 2 ** 62 <= k8.ABORT < 2 ** 63
    low = k8.ABORT & 0xFFFFFFFF
    for epoch in (1, 2, 1000, 2 ** 30):
        assert ((low - epoch) & 0xFFFFFFFF) < 2 ** 31
    with pytest.raises(ValueError):
        lay.word(k8.FLAG_WORDS)


@pytest.mark.parametrize("n_pub,rows,length", [(-1, 2, 8), (65, 2, 8),
                                                (1, 0, 8), (1, 2, 0)])
def test_buffer_layout_refuses(n_pub, rows, length):
    with pytest.raises(ValueError):
        k8.buffer_layout(n_pub, rows, length)


@pytest.mark.parametrize("name,value", [
    ("kArrivedWord", k8.ARRIVED_WORD), ("kPublishCountWord",
                                        k8.PUBLISH_COUNT_WORD),
    ("kConsumedWord", k8.CONSUMED_WORD), ("kPullCountWord",
                                          k8.PULL_COUNT_WORD),
    ("kFlagWords", k8.FLAG_WORDS), ("kMarks", k8.MARKS),
    ("kMaxShards", k8.MAX_SHARDS)])
def test_constants_mirror_the_cuda_source(name, value):
    m = re.search(rf"constexpr int {name} = (\d+);", CU)
    assert m and int(m.group(1)) == value


def test_abort_mirrors_the_cuda_source():
    m = re.search(r"kAbort = 1ULL << (\d+);", CU)
    assert m and k8.ABORT >> int(m.group(1)) == 1


@pytest.mark.parametrize("struct,cls", [("HaloParams", k8._Params),
                                        ("ExchangeParams",
                                         k8._ExchangeParams)])
def test_param_structs_mirror_the_cuda_source(struct, cls):
    body = re.search(rf"struct {struct} {{(.*?)}};", CU, re.S).group(1)
    names = re.findall(r"(\w+)(?:\[kMaxShards\])?;", body)
    assert names == [f for f, _ in cls._fields_]


# ----------------------------------------------------------------- plans
def test_plan_of_the_4x1_mesh_on_two_ranks():
    ranks = column(4, 2)
    p0, p1 = (k8.exchange_plan(ranks, r) for r in (0, 1))
    assert p0.publish == [k8.Publish(1, 0, reader=1, k=0)]
    assert [(q.t, q.kind) for q in p0.pulls] == [(0, "zeros"), (1, "local")]
    assert p1.publish == []
    assert p1.pulls[0] == k8.Pull(2, 0, "remote", 0, 0)
    assert p1.pulls[1] == k8.Pull(3, 0, "local")
    assert p0.remote == [] and p1.remote == [0]
    assert p0.peers == [1] and p1.peers == [0]


def test_plan_of_the_whole_2x2_mesh():
    ranks = rows_of(2, 2, 1)
    p0, p1 = (k8.exchange_plan(ranks, r) for r in (0, 1))
    assert p0.publish == [k8.Publish(0, 0, 1, 0), k8.Publish(0, 1, 1, 1)]
    assert [q.kind for q in p0.pulls] == ["zeros", "zeros"]
    assert p1.pulls == [k8.Pull(1, 0, "remote", 0, 0),
                        k8.Pull(1, 1, "remote", 0, 1)]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_every_halo_crossing_ranks_has_one_reader(layout):
    ranks = LAYOUTS[layout]
    n_ranks = 1 + max(r for row in ranks for r in row)
    plans = [k8.exchange_plan(ranks, r) for r in range(n_ranks)]
    readers = {}
    for pl in plans:
        assert len(pl.pulls) == sum(r == pl.rank for row in ranks
                                    for r in row)
        for k, q in enumerate(pl.pulls):
            if q.kind == "remote":
                pub = plans[q.source].publish[q.p]
                assert (pub.t, pub.s) == (q.t - 1, q.s)
                # the publisher raises this very destination's word
                assert (pub.reader, pub.k) == (pl.rank, k)
                assert q.source < pl.rank  # a chain along "time"
                readers.setdefault((q.source, q.p), []).append(pl.rank)
    assert sorted(readers) == sorted(
        (pl.rank, p) for pl in plans for p in range(len(pl.publish)))
    assert all(len(v) == 1 for v in readers.values())


def test_plan_refuses_more_shards_than_the_kernel_takes():
    with pytest.raises(ValueError, match="at most"):
        k8.exchange_plan(column(65, 65), 0)


# -------------------------------------------------------------- emulation
@pytest.mark.parametrize("blocks", [1, 3])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@settings(max_examples=25, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2 ** 32 - 1))
def test_emulated_exchange_under_random_interleavings(layout, blocks, seed):
    ranks = LAYOUTS[layout]
    em = k8.exchange_emulation(ranks, EPOCHS, random.Random(seed),
                               blocks=blocks)
    check(em, ranks, EPOCHS, blocks)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_emulated_exchange_with_a_starved_rank(layout):
    """Schedules that run one rank far behind the others (a late
    publisher or a late reader): the slots still hold what each pull
    waited for."""
    ranks = LAYOUTS[layout]
    n_ranks = 1 + max(r for row in ranks for r in row)
    for slow in range(n_ranks):
        class Starve(random.Random):
            """Moves the slow rank's blocks to the back of every pick."""

            def shuffle(self, x):
                super().shuffle(x)
                x.sort(key=lambda rg: rg[0] == slow)

        em = k8.exchange_emulation(ranks, EPOCHS, Starve(slow), blocks=2)
        check(em, ranks, EPOCHS, 2)


def test_one_slot_is_caught():
    """With one slot a publish overwrites a halo its reader may still be
    pulling: some schedule shows it."""
    caught = sum(bool(k8.exchange_emulation(
        column(4, 1), EPOCHS, random.Random(seed), slots=1).overwrites)
        for seed in range(20))
    assert caught > 0


def test_no_reuse_wait_is_caught():
    """Without the consumed wait, a publisher runs ahead of its reader:
    some schedule overwrites a slot before it is read, or a pull reads
    another epoch's halo."""
    caught = 0
    for seed in range(30):
        em = k8.exchange_emulation(column(4, 2), EPOCHS, random.Random(seed),
                                   reuse_wait=False)
        wrong = any(tags != [expected(e, t, s)] * 2
                    for (_, e, t, s), tags in em.reads.items())
        caught += bool(em.overwrites) or wrong
    assert caught > 0


def test_a_stuck_schedule_raises(monkeypatch):
    """A publisher that waits for a consumed word no one raises (its
    reader's pull of this very call) never publishes, and its reader
    never pulls: the emulation says so rather than looping."""
    monkeypatch.setattr(k8, "reuse_epoch", lambda e: e)
    with pytest.raises(RuntimeError, match="nothing can move"):
        k8.exchange_emulation(column(4, 2), 3, random.Random(0))


# -------------------------------------------------------- the time split
def test_split_us_reads_the_marks():
    """Marks of a launch with one published halo and two destinations (a
    remote pull, then a local one), two blocks a job."""
    m = np.zeros((3, 2, k8.MARKS), dtype=np.int64)
    # publish: starts at 0/100, waits 50/10, copies until 1000/1200
    m[0] = [[0, 50, 1000, 0, 0, 0], [100, 110, 1200, 0, 0, 0]]
    # remote pull: waits until 5000/5200, copies until 7000/6500
    m[1] = [[0, 5000, 7000, 0, 10, 3000], [200, 5200, 6500, 0, 20, 2000]]
    m[2] = [[300, 300, 900, 0, 0, 0], [300, 300, 800, 0, 0, 0]]
    got = k8.split_us(m, 1, [0])
    assert got == {"span_us": 7.0, "publish_us": 1.15,
                   "publish_wait_us": 0.05, "wait_us": 5.0,
                   "pull_us": 2.0, "pull_block_cycles": 2990}
    alone = k8.split_us(m[2:], 0, [])
    assert alone["publish_us"] is None and alone["pull_us"] is None


def test_host_sync_counter_counts_and_restores():
    saved = torch.Tensor.copy_
    with CountHostSyncs() as c:
        torch.zeros(3).copy_(torch.ones(3))
        torch.zeros(2).copy_(torch.ones(2))
    assert c.calls == 2
    assert torch.Tensor.copy_ is saved


# ------------------------------------------------------------ the watchdog
class _Event:
    """A stand-in for a CUDA event: complete once ``at`` has passed."""

    def __init__(self, at: float):
        self.at = at

    def query(self) -> bool:
        import time
        return time.monotonic() >= self.at


class _Halo:
    """What the watchdog uses of a ProcessHalo, on the CPU: one published
    halo, two destinations."""

    def __init__(self):
        self.failed, self.released = None, 0
        self.words = torch.zeros(k8.FLAG_WORDS, dtype=torch.int64)

    def fail(self, why):
        self.failed = self.failed or why

    def release_waits(self):
        self.released += 1
        self.words[k8.CONSUMED_WORD] = k8.ABORT
        self.words[k8.ARRIVED_WORD:k8.ARRIVED_WORD + 2] = k8.ABORT


@pytest.fixture
def cpu_watchdog():
    def make(timeout_s):
        halo = _Halo()
        return halo, k8._Watchdog(halo, timeout_s)

    return make


def test_watchdog_releases_a_wait_past_the_limit(cpu_watchdog):
    """A call whose stream reached its waits and stays unfinished past the
    limit: every wait word becomes ABORT and the exchange is failed."""
    import time

    halo, dog = cpu_watchdog(0.2)
    t0 = time.monotonic()
    entry = dog.add(_Event(t0))
    entry[1] = _Event(t0 + 1e9)  # never done
    dog.thread.join(5.0)
    assert not dog.thread.is_alive()
    assert 0.2 <= time.monotonic() - t0 < 2.0
    assert halo.failed is not None and halo.released == 1
    assert halo.words[k8.CONSUMED_WORD] == k8.ABORT
    assert (halo.words[k8.ARRIVED_WORD:k8.ARRIVED_WORD + 2] == k8.ABORT).all()
    assert int(halo.words.ne(0).sum()) == 3  # nothing else written


def test_watchdog_leaves_calls_that_finish_or_wait_their_turn(cpu_watchdog):
    """Calls done in time are dropped; a call whose stream has not reached
    its waits (earlier work still running) is not timed yet; a call still
    being queued (no event behind its launch) is not dropped."""
    import time

    halo, dog = cpu_watchdog(0.3)
    t0 = time.monotonic()
    done = dog.add(_Event(t0))
    done[1] = _Event(t0 + 0.1)
    late = dog.add(_Event(t0 + 1e9))  # its stream never reaches it
    time.sleep(1.0)
    assert halo.failed is None and not halo.words.any()
    assert list(dog.calls) == [late]
    assert late[1] is None
    dog.close()
    assert not dog.thread.is_alive()


def test_host_page_is_shared_by_name(monkeypatch):
    """A rank's wait words: the page its rank creates (zeroed) and another
    process attaches by name hold the same words; the owner's close
    removes the name.  CUDA's registration is stubbed on the CPU (the
    device address is the host's, as with unified addressing)."""
    from multiprocessing import shared_memory

    class Lib:
        registered = []

        def host_register(self, host, nbytes, dev):
            self.registered.append((host, nbytes))
            dev._obj.value = host
            return 0

        def host_unregister(self, host):
            return 0

    monkeypatch.setattr(k8, "_lib", lambda: Lib())
    # the attacher is this process too: its tracker entry is the owner's
    from multiprocessing import resource_tracker
    monkeypatch.setattr(resource_tracker, "unregister", lambda *a: None)
    own = k8._HostPage()
    other = k8._HostPage(own.name)
    assert not own.words.any() and own.dev == own.host
    other.words[k8.ARRIVED_WORD + 1] = 5
    assert own.words[k8.ARRIVED_WORD + 1] == 5
    assert [n for _, n in Lib.registered] == [k8._HostPage.BYTES] * 2
    name = own.name
    other.close()
    own.close()
    with pytest.raises(FileNotFoundError):
        shared_memory.SharedMemory(name=name)

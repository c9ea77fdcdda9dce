"""Overlap policies — the paper's §IV-C framework taxonomy, reified.

A copy of :mod:`repro.core.policies`.

The paper distinguishes the four studied frameworks by exactly three
boolean pipeline choices plus the comm schedule:

=============  ===========  ============  =========
framework      overlap_io   h2d_early     overlap_comm (WFBP)
=============  ===========  ============  =========
Caffe-MPI      yes          yes           yes
MXNet          yes          no            yes
TensorFlow     yes          no            yes
CNTK           yes          no            no
naive S-SGD    no           no            no
=============  ===========  ============  =========

Beyond-paper policies: the ``bucketed-{1,4,25,100}mb`` family fuses
layer-wise gradients into size-targeted buckets (DDP/Horovod style —
the fix for the 9.6% network utilization the paper measured on
InfiniBand; the size axis sweeps latency amortization against overlap
lost to coarser release granularity), and ``PRIORITY`` frees the
comm-channel FIFO so smaller/earlier-needed tensors may overtake
(ByteScheduler style).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Policy:
    name: str
    overlap_io: bool = False      # prefetch next batch during compute
    h2d_early: bool = False       # copy to device buffer before update finishes
    overlap_comm: bool = False    # WFBP: layer-wise all-reduce inside backward
    serialize_comm: bool = True   # collective channel is FIFO (single NCCL stream)
    bucket_bytes: float | None = None   # fuse gradients into >= this many bytes
    priority_comm: bool = False   # allow priority scheduling on the net channel

    def describe(self) -> str:
        bits = []
        bits.append("io-overlap" if self.overlap_io else "blocking-io")
        bits.append("early-h2d" if self.h2d_early else "late-h2d")
        bits.append("wfbp" if self.overlap_comm else "comm-at-end")
        if self.bucket_bytes:
            bits.append(f"bucket={self.bucket_bytes / 1e6:.0f}MB")
        if self.priority_comm:
            bits.append("priority")
        return f"{self.name}({', '.join(bits)})"


NAIVE = Policy("naive")
CNTK = Policy("cntk", overlap_io=True)
MXNET = Policy("mxnet", overlap_io=True, overlap_comm=True)
TENSORFLOW = Policy("tensorflow", overlap_io=True, overlap_comm=True)
CAFFE_MPI = Policy("caffe-mpi", overlap_io=True, h2d_early=True, overlap_comm=True)

# Beyond-paper optimizations (§VII future work).  The bucket-size
# family sweeps the fusion axis the paper's conclusion asks about:
# 1 MB (latency still dominates), 4 MB, 25 MB (DDP's default) and
# 100 MB (one-ish bucket for the paper CNNs ≈ comm-at-end with a fused
# collective).
def _bucketed(mb: float) -> Policy:
    return Policy(f"bucketed-{mb:g}mb", overlap_io=True, h2d_early=True,
                  overlap_comm=True, bucket_bytes=mb * 1e6)


BUCKETED_1MB = _bucketed(1)
BUCKETED_4MB = _bucketed(4)
BUCKETED_25MB = _bucketed(25)
BUCKETED_100MB = _bucketed(100)
BUCKETED_POLICIES = {p.name: p for p in
                     (BUCKETED_1MB, BUCKETED_4MB, BUCKETED_25MB,
                      BUCKETED_100MB)}
# No serialize_comm chain edges: the net channel still executes one
# collective at a time (channel constraint), but the *order* is the
# priority queue's to choose — otherwise issue-order FIFO edges would
# pin the schedule and the priorities could never reorder anything.
PRIORITY = Policy("priority", overlap_io=True, h2d_early=True,
                  overlap_comm=True, serialize_comm=False,
                  priority_comm=True)

FRAMEWORK_POLICIES = {
    "caffe-mpi": CAFFE_MPI,
    "cntk": CNTK,
    "mxnet": MXNET,
    "tensorflow": TENSORFLOW,
}

ALL_POLICIES = dict(FRAMEWORK_POLICIES, naive=NAIVE,
                    **BUCKETED_POLICIES, priority=PRIORITY)


def get_policy(name: str) -> Policy:
    try:
        return ALL_POLICIES[name]
    except KeyError:
        raise KeyError(f"unknown policy {name!r}; one of {sorted(ALL_POLICIES)}")

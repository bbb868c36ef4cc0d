"""Epoch plans: deterministic multi-pass batch schedules over a shard
store, resumable at any batch boundary (counterpart of
``sq_learn_tpu/oocore/epochs.py``; pure numpy, so both packages yield the
same batches from the same store).

- **shard-order shuffle**: each epoch visits the shards in an order drawn
  from an RNG keyed on ``(seed, epoch)``;
- **within-shard shuffle**: each shard's rows are permuted by an RNG
  keyed on ``(seed, epoch, shard)``;
- batch j is rows ``[j·b, (j+1)·b)`` of the concatenation of the permuted
  shards in the shuffled order, so a batch touches at most the shards its
  window spans.

Every RNG is keyed, never sequential, so the schedule of ``(seed, epoch,
batch)`` is a pure function: restarting at batch ``B`` skips the shards
wholly before it without reading them and replays the batches an
uninterrupted run would have produced.
"""

import numpy as np

__all__ = ["EpochPlan"]


class EpochPlan:
    """The deterministic multi-epoch batch schedule over a row source
    (:class:`~.store.ShardStore` or :class:`~.store.ArraySource`)."""

    def __init__(self, seed=0, batch_rows=1024):
        self.seed = int(seed)
        self.batch_rows = int(batch_rows)
        if self.batch_rows < 1:
            raise ValueError(f"batch_rows must be >= 1, got {batch_rows}")

    def n_batches(self, n_rows):
        return -(-int(n_rows) // self.batch_rows)

    def shard_order(self, source, epoch):
        rng = np.random.default_rng((self.seed, int(epoch), 0xE90C))
        return rng.permutation(source.n_shards)

    def host_partition(self, source, epoch, n_hosts, host_id, *,
                       start_pos=0):
        """``(position, shard)`` pairs of this epoch's visit order owned by
        ``host_id`` of an ``n_hosts`` world: position ``p`` of
        :meth:`shard_order` belongs to host ``p % n_hosts``. A pure
        function of ``(seed, epoch, n_hosts)``: the partitions are
        disjoint and their union is the visit order. ``start_pos`` (a
        resumed cursor, a visit-order position) leaves out the positions
        already folded."""
        n_hosts = int(n_hosts)
        host_id = int(host_id)
        if n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
        if not 0 <= host_id < n_hosts:
            raise ValueError(
                f"host_id must be in [0, {n_hosts}), got {host_id}")
        order = self.shard_order(source, epoch)
        return [(p, int(order[p]))
                for p in range(int(start_pos), len(order))
                if p % n_hosts == host_id]

    def shard_perm(self, source, epoch, shard):
        rng = np.random.default_rng(
            (self.seed, int(epoch), int(shard), 0x5E0))
        return rng.permutation(source.shard_sizes[int(shard)])

    def iter_batches(self, source, epoch, start_batch=0):
        """Yield ``(batch_index, batch_rows_array)`` for one epoch from
        ``start_batch`` (the resume cursor). The tail batch carries the
        remainder rows, unpadded. Shards wholly before the resume point
        are never read; the rest are read ahead on the bounded prefetcher
        (:mod:`.prefetch`, ``SQ_OOC_PREFETCH_DEPTH``; depth changes
        nothing but overlap)."""
        from .prefetch import iter_shards

        n = source.shape[0]
        b = self.batch_rows
        skip = int(start_batch) * b
        if skip >= n:
            return
        # the visit order (shard, rows to drop): only the first visited
        # shard carries a resume drop, and the order is what is read ahead
        visit = []
        for s in self.shard_order(source, epoch):
            rows_s = source.shard_sizes[int(s)]
            if skip >= rows_s:
                skip -= rows_s
                continue
            visit.append((int(s), skip))
            skip = 0
        chunks, have = [], 0
        bi = int(start_batch)
        shards = iter_shards(source, [s for s, _ in visit])
        try:
            for (s, drop), raw in zip(visit, shards):
                perm = self.shard_perm(source, epoch, s)
                if drop:
                    perm = perm[drop:]
                arr = raw[perm]
                chunks.append(arr)
                have += arr.shape[0]
                while have >= b:
                    block = chunks[0] if len(chunks) == 1 \
                        else np.concatenate(chunks, axis=0)
                    yield bi, block[:b]
                    rest = block[b:]
                    chunks, have = ([rest], rest.shape[0]) if rest.size \
                        else ([], 0)
                    bi += 1
        finally:
            shards.close()
        if have:
            yield bi, (chunks[0] if len(chunks) == 1
                       else np.concatenate(chunks, axis=0))

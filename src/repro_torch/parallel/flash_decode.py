"""Flash decoding over a sequence-sharded KV cache — counterpart of
``repro.parallel.flash_decode``.

The cache is split into ``n_shards`` sequence blocks over the mesh's
``model`` axis. The block that holds the write position takes the new K/V;
each block computes its partial attention with fp32 statistics, and the
partials merge with the log-sum-exp combine: a ``pmax`` and two ``psum`` of
O(B·H) statistics and one output, not the cache.

On a mesh of virtual ranks the impl holds the whole cache and runs each
block's program in turn. On a process mesh (``launch.mesh.dist_mesh``) a
rank holds its block ``[b, S/M, K, hd]`` of its data group's rows (its
``cache_spec`` block, ``parallel.tp.CacheBlocks``), at positions offset by
rank·S/M; the combine runs over the model comm (``DistComm.pmax``/
``psum``, counted).
"""

from __future__ import annotations

import math

import torch


def make_flash_decode(mesh, axis: str = "model"):
    """Returns ``impl(q, k_cache, v_cache, new_k, new_v, cache_len) ->
    (out [B, 1, H, hd], k_cache, v_cache)``, or ``None`` from ``impl`` when
    the cache's length does not split into the shards (the caller then
    takes the dense path).

    ``cache_len`` is the scalar write position (a 0-d tensor or an int);
    a per-slot ``[B]`` length raises ``ValueError``. The caches are
    written in place, as the port's ``layers.attention`` writes them: at
    the write position only the owning block changes (the others store
    back the row they hold, which keeps the branch on the device).
    """
    comm = mesh.comm
    if mesh.local_rows:
        return _rank_impl(comm)
    n_shards = mesh.shape[axis]
    n_dp = mesh.dp_size

    def impl(q, k_cache, v_cache, new_k, new_v, cache_len):
        B, S, K, hd = k_cache.shape
        H = q.shape[2]
        if S % n_shards:
            return None
        idx = torch.as_tensor(cache_len, device=k_cache.device)
        if idx.dim() != 0:
            raise ValueError(
                f"flash decoding takes a scalar cache_len, not shape "
                f"{tuple(idx.shape)}; per-slot lengths take the dense path")
        s_loc = S // n_shards
        owner, local_idx = idx // s_loc, idx % s_loc
        n = n_dp if B % n_dp == 0 else 1
        outs = [_group(q, k_cache, v_cache, new_k, new_v,
                       slice(i * B // n, (i + 1) * B // n), idx, owner,
                       local_idx, s_loc, H, K, hd) for i in range(n)]
        return torch.cat(outs, 0), k_cache, v_cache

    def _group(q, k_cache, v_cache, new_k, new_v, rows, idx, owner,
               local_idx, s_loc, H, K, hd):
        """One data group's rows: its program over the model axis."""
        q, new_k, new_v = q[rows], new_k[rows], new_v[rows]
        b = q.shape[0]
        g = H // K
        qg = q.reshape(b, 1, K, g, hd)
        stats = []
        for r in comm.ranks:
            blk = slice(r * s_loc, (r + 1) * s_loc)
            # The owner's local write: this block's row at local_idx (a
            # one-element index: a 0-d one would read it on the host, which
            # the meta device, the hill-climb's count, cannot).
            at = (r * s_loc + local_idx).reshape(1).long()
            for cache, new in ((k_cache, new_k), (v_cache, new_v)):
                mine = cache[rows]
                mine.index_copy_(1, at, torch.where(
                    owner == r, new, mine.index_select(1, at)))
            pos = r * s_loc + torch.arange(s_loc, device=q.device)
            stats.append(_partial(qg, k_cache[rows, blk], v_cache[rows, blk],
                                  pos, idx, hd))
        m_glob = comm.pmax([m for m, _, _ in stats])
        corr = [torch.exp(m - mg) for (m, _, _), mg in zip(stats, m_glob)]
        l_glob = comm.psum([l * c for (_, l, _), c in zip(stats, corr)])
        o_glob = comm.psum([o * c[..., None].permute(0, 3, 1, 2, 4).to(o.dtype)
                            for (_, _, o), c in zip(stats, corr)])
        out = o_glob[0] / torch.clamp(
            l_glob[0][..., None].permute(0, 3, 1, 2, 4), min=1e-30
        ).to(o_glob[0].dtype)
        return out.reshape(b, 1, H, hd)

    return impl


def _partial(qg, k_loc, v_loc, pos, idx, hd):
    """One block's attention partials: (max, sum of exps, output) with
    fp32 statistics, positions past ``idx`` masked."""
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k_loc).float()
    s = s * (1.0 / math.sqrt(hd))
    s = torch.where((pos <= idx)[None, None, None, None, :], s, -1e30)
    m_loc = s.amax(-1)                                      # [b, K, g, 1]
    p = torch.exp(s - m_loc[..., None])
    return m_loc, p.sum(-1), torch.einsum("bkgqs,bskd->bqkgd",
                                           p.to(v_loc.dtype), v_loc)


def _rank_impl(comm):
    """Flash decoding on a process mesh: ``impl(q, k_block, v_block, new_k,
    new_v, cache_len)`` with this rank's blocks of the caches, written in
    place (the owner of the write position alone changes its block);
    ``q`` [b, 1, H, hd] and the new k/v [b, 1, K, hd] hold every head."""

    def impl(q, k_blk, v_blk, new_k, new_v, cache_len):
        b, s_loc, K, hd = k_blk.shape
        H = q.shape[2]
        idx = torch.as_tensor(cache_len, device=k_blk.device)
        if idx.dim() != 0:
            raise ValueError(
                f"flash decoding takes a scalar cache_len, not shape "
                f"{tuple(idx.shape)}")
        r = comm.rank
        owner = idx // s_loc
        at = (idx % s_loc).reshape(1).long()
        for cache, new in ((k_blk, new_k), (v_blk, new_v)):
            cache.index_copy_(1, at, torch.where(
                owner == r, new, cache.index_select(1, at)))
        qg = q.reshape(b, 1, K, H // K, hd)
        pos = r * s_loc + torch.arange(s_loc, device=q.device)
        m_loc, l_loc, o_loc = _partial(qg, k_blk, v_blk, pos, idx, hd)
        m_glob = comm.pmax([m_loc])[0]
        corr = torch.exp(m_loc - m_glob)
        l_glob = comm.psum([l_loc * corr])[0]
        o_glob = comm.psum([o_loc * corr[..., None].permute(0, 3, 1, 2, 4)
                            .to(o_loc.dtype)])[0]
        out = o_glob / torch.clamp(
            l_glob[..., None].permute(0, 3, 1, 2, 4), min=1e-30
        ).to(o_glob.dtype)
        return out.reshape(b, 1, H, hd), k_blk, v_blk

    return impl

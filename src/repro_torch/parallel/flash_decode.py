"""Flash decoding over a sequence-sharded KV cache — counterpart of
``repro.parallel.flash_decode``.

The cache is split into ``n_shards`` sequence blocks over the mesh's
``model`` axis. The block that holds the write position takes the new K/V;
each block computes its partial attention with fp32 statistics, and the
partials merge with the log-sum-exp combine: a ``pmax`` and two ``psum`` of
O(B·H) statistics and one output, not the cache.
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
            k_loc, v_loc = k_cache[rows, blk], v_cache[rows, blk]
            s = torch.einsum("bqkgd,bskd->bkgqs", qg, k_loc).float()
            s = s * (1.0 / math.sqrt(hd))
            pos = r * s_loc + torch.arange(s_loc, device=q.device)
            s = torch.where((pos <= idx)[None, None, None, None, :], s,
                            -1e30)
            m_loc = s.amax(-1)                              # [b, K, g, 1]
            p = torch.exp(s - m_loc[..., None])
            l_loc = p.sum(-1)
            o_loc = torch.einsum("bkgqs,bskd->bqkgd", p.to(v_loc.dtype),
                                 v_loc)
            stats.append((m_loc, l_loc, o_loc))
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

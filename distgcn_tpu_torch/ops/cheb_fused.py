"""Fused ChebGCN layer over 0/1 structure blocks — the large-graph forward.

Port of `distgcn_tpu/ops/cheb_fused.py`. For a 0/1 adjacency the
normalization is separable, Anorm = diag(r) A diag(r) with r = deg^-1/2,
so a K=1 layer ``act(h@W0 + L@(h@W1) + b)`` with L = I - Anorm is

    out = act( h @ (W0+W1) + b - r * ((A @ (r * h)) @ W1) )

and needs only A's structure blocks. `fused_cheb_layer` runs one layer:
its plain version on CPU tensors, the CUDA kernel
(`ops/cheb_fused_cuda.py`) on CUDA tensors. Numerics are the Pallas
kernel's: the A-product is bf16(ind * r_col) x bf16 activations with f32
accumulation, the W-products are f32, the row scaling is
bf16(r_row) * bf16(lag); hidden layers emit bf16, the head f32.

The JAX package pads the feature width to 128 lanes; the port pads it to
a multiple of 32 (zero padding is exact).
"""

from __future__ import annotations

import torch

from distgcn_tpu_torch.ops.spmm import _block_rows, block_values


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def pad_layer_params(layer: dict, f: int) -> dict:
    """Pad a ChebGCN layer's params ({'w_0', 'w_1' [Fin, Fout], optional
    'bias'}) to the kernel's width: {'w1', 'w01' [f, f] f32, 'bias' [1, f]
    f32}. Zero padding is exact: padded input lanes are zero and padded
    output lanes are ignored by the next layer's zero weight rows."""
    w0 = torch.as_tensor(layer["w_0"], dtype=torch.float32)
    w1 = torch.as_tensor(layer["w_1"], dtype=torch.float32, device=w0.device)
    fi, fo = w0.shape
    if fi > f or fo > f:
        raise ValueError(f"layer {tuple(w0.shape)} wider than f={f}")
    pad = (0, f - fo, 0, f - fi)
    w0p = torch.nn.functional.pad(w0, pad)
    w1p = torch.nn.functional.pad(w1, pad)
    bias = layer.get("bias")
    bp = torch.zeros((1, f), dtype=torch.float32, device=w0.device)
    if bias is not None:
        bp[0, :fo] = torch.as_tensor(bias, dtype=torch.float32,
                                     device=w0.device).reshape(-1)
    return {"w1": w1p, "w01": w0p + w1p, "bias": bp}


def fused_cheb_layer_plain(ind_vals: torch.Tensor, row_ptr: torch.Tensor,
                           blk_cols: torch.Tensor, x: torch.Tensor,
                           r: torch.Tensor, w1: torch.Tensor,
                           w01: torch.Tensor, bias: torch.Tensor,
                           n_rows: int, block_size: int, act_mode: int,
                           out_dtype: torch.dtype = torch.bfloat16,
                           bitmap: bool = False) -> torch.Tensor:
    """Plain PyTorch fused layer; same contract as `fused_cheb_layer`."""
    bs = block_size
    f = x.shape[1]
    ind = block_values(ind_vals, bs, bitmap)                   # [nb, bs, bs]
    r_cols = r.reshape(-1, bs)[blk_cols.long()]                # [nb, bs]
    inds = _bf16(ind * r_cols[:, None, :])
    xs = x.reshape(-1, bs, f)[blk_cols.long()].to(torch.float32)
    acc = torch.zeros((n_rows // bs, bs, f), dtype=torch.float32,
                      device=x.device)
    acc.index_add_(0, _block_rows(row_ptr), torch.bmm(inds, xs))
    acc = acc.reshape(n_rows, f)
    y = x.to(torch.float32) @ w01
    lag = acc @ w1
    out = (y - _bf16(r)[:, None] * _bf16(lag)) + bias.reshape(1, f)
    if act_mode == 1:
        out = torch.maximum(out, 0.2 * out)
    return out.to(out_dtype)


def fused_cheb_layer(ind_vals, row_ptr, blk_cols, x, r, w1, w01, bias,
                     n_rows: int, block_size: int, act_mode: int,
                     out_dtype: torch.dtype = torch.bfloat16,
                     bitmap: bool = False) -> torch.Tensor:
    """One fused ChebGCN layer (K=1).

    ind_vals: int8 [nb, bs, bs] 0/1 blocks, or bitmap int32
    [nb, bs//32, bs] blocks with ``bitmap=True``; row_ptr [R+1] and
    blk_cols [nb] int32, blocks sorted by row. x: [n_rows, F] bf16
    activations. r: [n_rows] f32 = deg^-1/2. w1/w01: [F, F] f32
    (W01 = W0 + W1). bias: [1, F] or [F] f32. act_mode 1 = leaky_relu(0.2),
    0 = identity. Returns [n_rows, F] `out_dtype`.
    """
    if x.device.type == "cpu":
        return fused_cheb_layer_plain(ind_vals, row_ptr, blk_cols, x, r, w1,
                                      w01, bias, n_rows, block_size,
                                      act_mode, out_dtype, bitmap)
    from distgcn_tpu_torch.ops.cheb_fused_cuda import fused_cheb_layer_kernel
    return fused_cheb_layer_kernel(ind_vals, row_ptr, blk_cols, x, r, w1,
                                   w01, bias.reshape(-1), n_rows, block_size,
                                   act_mode, out_dtype, bitmap)


def pad_params(params_list) -> list:
    """`pad_layer_params` of every layer, at the widest layer's width
    rounded up to a multiple of 32."""
    dims = [d for p in params_list for d in p["w_0"].shape]
    f = -(-max(dims) // 32) * 32
    return [pad_layer_params(layer, f) for layer in params_list]


def fused_forward(ind_vals, row_ptr, blk_cols, r, layers, feats,
                  n_rows: int, block_size: int, final_act_mode: int = 0,
                  bitmap: bool = False) -> torch.Tensor:
    """L-layer fused ChebGCN forward (K=1): leaky_relu(0.2) hidden layers,
    the head's act per ``final_act_mode`` (0 identity, 1 leaky_relu).
    layers: `pad_params` of the per-layer params, on feats' device.
    feats: [n_rows, F0] f32, cast to bf16 on entry; r: [n_rows] or
    [n_rows, 1] f32. Returns [n_rows, F] f32 at the padded width F; the
    lanes past the head's width are 0."""
    f = layers[0]["w1"].shape[0]
    h = torch.nn.functional.pad(feats.to(torch.float32),
                                (0, f - feats.shape[1])).to(torch.bfloat16)
    r = r.reshape(-1).to(torch.float32).contiguous()
    nl = len(layers)
    for li, p in enumerate(layers):
        last = li == nl - 1
        h = fused_cheb_layer(
            ind_vals, row_ptr, blk_cols, h.contiguous(), r, p["w1"],
            p["w01"], p["bias"], n_rows, block_size,
            act_mode=final_act_mode if last else 1,
            out_dtype=torch.float32 if last else torch.bfloat16,
            bitmap=bitmap)
    return h

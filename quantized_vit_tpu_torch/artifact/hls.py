"""FPGA HLS headers of UltraNet (``quantized_vit_tpu/artifact/hls.py``):
the reference's deployment artifact, a ``param.h``/``config.h`` pair for an
external FPGA accelerator, reproduced from the params trees.

- :func:`pack_words`: each row's values LSB-first, two's complement at
  ``elem_bit`` bits, ``simd`` values a word (a ragged tail packs into a
  shorter last word);
- :func:`tile_pe`: ``[O][T0]`` SIMD words re-tiled into ``[PE][W_TILES]``
  (PE adjacent output channels in lockstep, tiles word-major within each
  block of PE rows);
- :func:`inc_bias_tiles`: a per-channel vector as ``[PE][A_TILES]``;
- :func:`int_bit_width`: the max magnitude's bit length plus a sign bit;
- the header text: weight, inc and bias array initializers and the
  ``#define`` geometry macros, byte for byte the JAX package's.

Kernels are HWIO in the tree; the reference flattens ``[O, K, K, I]``,
which is ``moveaxis(-1, 0)``.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..models.ultranet import (ULTRANET_LAYERS, ULTRANET_OUT_CHANNELS,
                               channels_of)
from .ultranet import (UltraNetExportConfig, as_tensors,
                       export_ultranet_int, generate_ultranet_config)

# per-layer SIMD/PE memory geometry of conv_0..conv_8
# (ultranet_param_gen.py:21-22)
ULTRANET_SIMD = (3, 16, 16, 16, 8, 8, 8, 8, 8)
ULTRANET_PE = (16, 8, 8, 4, 2, 2, 2, 2, 2)


def pack_words(rows: np.ndarray, elem_bit: int, simd: int) -> List[List[int]]:
    """Each row's values as big ints, ``simd`` values a word."""
    rows = np.asarray(rows)
    out: List[List[int]] = []
    mask = (1 << elem_bit) - 1
    for row in rows:
        words = []
        for start in range(0, len(row), simd):
            word = 0
            for lane, v in enumerate(row[start:start + simd]):
                word |= (int(v) & mask) << (elem_bit * lane)
            words.append(word)
        out.append(words)
    return out


def tile_pe(words: Sequence[Sequence[int]], pe: int) -> List[List[int]]:
    """``[O][T0]`` SIMD words -> ``[PE][W_TILES]``."""
    n_rows, t0 = len(words), len(words[0])
    if n_rows % pe != 0:
        raise ValueError(f"out channels {n_rows} not divisible by pe {pe}")
    res = [[0] * (t0 * (n_rows // pe)) for _ in range(pe)]
    t = 0
    for blk in range(n_rows // pe):
        for j in range(t0):
            for p in range(pe):
                res[p][t] = words[blk * pe + p][j]
            t += 1
    return res


def inc_bias_tiles(vec: np.ndarray, pe: int) -> np.ndarray:
    """A per-channel integer vector -> [PE][A_TILES]."""
    return np.asarray(vec).reshape(-1, pe).T


def int_bit_width(arr) -> int:
    """Bits of the max magnitude plus a sign bit."""
    abs_max = int(np.abs(np.asarray(arr)).max())
    return len(bin(abs_max)) - 2 + 1


def _array_init_str(arr2d) -> str:
    return ",\n".join(
        "{\"" + "\", \"".join(hex(int(v)) for v in row) + "\"}"
        for row in arr2d
    ) + "};\n"


def w_init_str(name: str, w: Sequence[Sequence[int]], w_bit: int, pe: int,
               simd: int) -> str:
    res = f"// {name}_w\n"
    res += "//PEs = %d, SIMD = %d\n" % (pe, simd)
    res += "//bit = %d\n" % w_bit
    res += f"const ap_uint<{w_bit * simd}> {name}_w"
    res += "[%d][%d] = {\n" % (len(w), len(w[0]))
    return res + _array_init_str(w)


def _vec_init_str(kind: str, name: str, arr: np.ndarray, bit: int) -> str:
    res = f"// {kind}\n"
    res += f"// {name}_{kind}\n"
    res += "// w_bit = %d\n" % bit
    res += f"const ap_int<{bit}> {name}_{kind}"
    res += "[%d][%d] = {\n" % (arr.shape[0], arr.shape[1])
    return res + _array_init_str(arr)


def config_macro(name: str, key: str, value: int) -> str:
    return "#define %s_%s %d \n" % (name.upper(), key.upper(), int(value))


class HLSLayer:
    """One fused conv + BN + activation layer in the accelerator's memory
    layout."""

    def __init__(self, name: str, entry: Dict[str, Any], pe: int, simd: int,
                 last: bool = False):
        self.name, self.entry = name, entry
        self.pe, self.simd, self.last = pe, simd, last
        self.w: List[List[int]] = []
        self.inc: Optional[np.ndarray] = None
        self.bias: Optional[np.ndarray] = None
        self.w_tiles = self.a_tiles = 0
        self.inc_bit = self.bias_bit = 0

    def process(self, kernel_int: np.ndarray,
                inc: Optional[np.ndarray] = None,
                bias: Optional[np.ndarray] = None):
        """A conv: HWIO -> [O, K, K, I] -> [O, K*K*I], packed and tiled."""
        okki = np.moveaxis(np.asarray(kernel_int), -1, 0)
        self.w = tile_pe(pack_words(okki.reshape(okki.shape[0], -1),
                                    self.entry["w_bit"], self.simd), self.pe)
        self.w_tiles = len(self.w[0])
        if not self.last:
            self.inc = inc_bias_tiles(inc, self.pe)
            self.bias = inc_bias_tiles(bias, self.pe)
            self.a_tiles = self.inc.shape[1]
            self.inc_bit = int_bit_width(self.inc)
            self.bias_bit = int_bit_width(self.bias)
        return self

    def param_str(self) -> str:
        res = w_init_str(self.name, self.w, self.entry["w_bit"], self.pe,
                         self.simd)
        if not self.last:
            res += _vec_init_str("inc", self.name, self.inc, self.inc_bit)
            res += _vec_init_str("bias", self.name, self.bias, self.bias_bit)
        return res

    def config_str(self) -> str:
        e = self.entry
        res = f"// {self.name}\n"
        for key, val in (("K", e["k"]), ("S", e["s"]), ("P", e["p"])):
            res += config_macro(self.name, key, val)
        # the reference's config.json is [C, H, W]; the table is [H, W, C]
        ih, iw, ic = e["in_shape"]
        oh, ow, oc = e["out_shape"]
        for key, val in (("IFM_CH", ic), ("IFM_ROW", ih), ("IFM_COL", iw),
                         ("OFM_CH", oc), ("OFM_ROW", oh), ("OFM_COL", ow),
                         ("SIMD", self.simd), ("PE", self.pe),
                         ("IN_BIT", e["in_bit"])):
            res += config_macro(self.name, key, val)
        if not self.last:
            res += config_macro(self.name, "OUT_BIT", e["out_bit"])
        res += config_macro(self.name, "W_BIT", e["w_bit"])
        if not self.last:
            res += config_macro(self.name, "INC_BIT", self.inc_bit)
            res += config_macro(self.name, "BIAS_BIT", self.bias_bit)
        res += config_macro(self.name, "W_TILES", self.w_tiles)
        if not self.last:
            res += config_macro(self.name, "A_TILES", self.a_tiles)
        res += config_macro(self.name, "L_SHIFT", e["l_shift"])
        return res + "\n"


def hls_texts(int_params: Dict[str, Any], table: List[Dict[str, Any]],
              simd: Sequence[int] = ULTRANET_SIMD,
              pe: Sequence[int] = ULTRANET_PE) -> Dict[str, str]:
    """``param.h`` and ``config.h`` texts of an integer tree (as
    :func:`~quantized_vit_tpu_torch.artifact.ultranet.export_ultranet_int`
    returns it, tensors or numpy arrays) and its geometry table. Each
    layer's PE degrades to gcd(out channels, PE), so a pruned width
    still tiles; config.h carries the effective PE."""
    n = len(ULTRANET_LAYERS)
    arr = {k: np.asarray(v.detach().cpu() if hasattr(v, "cpu") else v)
           for k, v in int_params.items()}
    widths = [int(arr[f"conv_{i}_kernel_int"].shape[-1]) for i in range(n)]
    pe = [math.gcd(ch, int(p)) for ch, p in zip(widths, pe)] + [
        math.gcd(ULTRANET_OUT_CHANNELS, int(pe[n]))]
    by_name = {e["name"]: e for e in table}
    param_parts: List[str] = []
    config_parts: List[str] = []
    for i in range(n + 1):
        name = f"conv_{i}"
        last = i == n
        layer = HLSLayer(name, by_name[name], pe[i], simd[i], last=last)
        if last:
            layer.process(arr[f"{name}_kernel_int"])
        else:
            layer.process(arr[f"{name}_kernel_int"], arr[f"{name}_inc"],
                          arr[f"{name}_bias_int"])
        param_parts.append(layer.param_str())
        config_parts.append(layer.config_str())
    return {"param": "".join(param_parts), "config": "".join(config_parts)}


def write_hls(out_dir: str, texts: Dict[str, str], last_bias) -> None:
    """``param.h``, ``config.h`` and ``last_bias.npy``/``.bin`` into
    ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "param.h"), "w") as f:
        f.write(texts["param"])
    with open(os.path.join(out_dir, "config.h"), "w") as f:
        f.write(texts["config"])
    last_bias = np.asarray(last_bias, np.float32)
    np.save(os.path.join(out_dir, "last_bias.npy"), last_bias)
    last_bias.tofile(os.path.join(out_dir, "last_bias.bin"))


def export_ultranet_hls(params: Dict[str, Any], batch_stats: Dict[str, Any],
                        out_dir: str,
                        exp: Optional[UltraNetExportConfig] = None,
                        simd: Sequence[int] = ULTRANET_SIMD,
                        pe: Sequence[int] = ULTRANET_PE) -> Dict[str, str]:
    """``param.h``, ``config.h`` and ``last_bias.npy|.bin`` into
    ``out_dir`` from trained UltraNet params (the
    ``ultranet_param_gen.py`` flow); returns the two header texts."""
    exp = exp or UltraNetExportConfig()
    params, batch_stats = as_tensors(params), as_tensors(batch_stats)
    table = generate_ultranet_config(exp, channels=channels_of(params))
    texts = hls_texts(export_ultranet_int(params, batch_stats, exp), table,
                      simd, pe)
    last = params[f"conv_{len(ULTRANET_LAYERS)}"]["bias"]
    write_hls(out_dir, texts, last.detach().cpu().numpy())
    return texts

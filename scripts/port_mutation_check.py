#!/usr/bin/env python3
"""Mutation check of the port's KIVI region kernels, MInference's
block-sparse prefill kernels and the db slash wrapper, the H2O kernels, the
chunked prefill's flash kernels, the two-pass flash schedule, the split
decode kernel and the int4 decode matmul kernel (Gemma-2's head dim 256 and
logit cap among them), on a CUDA card.

    python3 scripts/port_mutation_check.py [--only NAMES] [--log FILE]

Copies ``pyramidkv_tpu_torch``, ``chip_smoke.py``, ``configs/minference``
and the trained grid's pin (``tests/torch_trained_tokens.json``) into a
temporary directory once per mutant, breaks
one file of the package there (a CUDA source, or a kernel wrapper's
Python), and runs the ``chip_smoke`` phase that checks it against the
broken kernels (each copy builds its own libraries; every check runs
untimed).  A mutant is caught when it fails the tolerance at every main
shape (the checks whose case is not a short one) of the checks it
targets; the script prints, per mutant, the smallest ``err_over_tol`` over
those and over the short checks (where a mutant may not bite: a region too
short for warp 1), and exits non-zero if a mutant was not caught.
Mutants (the ``d32_`` ones break the head-dim-32 kernels of the trained
checkpoint, checked by ``phase_trained_kernel_checks``: flash skipping the
diagonal tile or the last 8 channels of P V, H2O stats without the W x W
block's causal mask, colsum reading one row's offset for a pair, decode
lanes reading the first 4 chunks' channels only, the KIVI group kernel's
V byte of lane % 16 and its tail K from lane 0's channels):

- ``drop_plane`` (``csrc/quant_region.cuh``): the pa layout's split kernel
  reads the V codes of its last <= 4-bit field as 0 (the last bit-plane;
  with 8-bit codes their high nibble) (``region_drop_plane`` is the same
  fault in the group kernel);
- ``drop_chunk`` (``csrc/quant_region.cuh``): warp 1 of the pa layout's
  split kernel skips its first 16-row unit of every split (slots never
  attended);
- ``pa_last_unit_reads_unwaited_stage``: each warp of the pa split kernel
  reads its last unit from the ring stage after the one it waited for (a
  stage whose copy it never waited for);
- ``pa_plane_folds_next_group``: the pa split kernel folds plane p's query
  and zero term with the K scale and zero group of plane p + 1 (targets
  the checks with K groups, the chunked carry's);
- ``pa_merge_drops_last_split``: the pa finish pass leaves each region's
  last split out of the merge (targets the checks of more than one
  split);
- ``slash_drop_last_tile`` (``csrc/block_sparse_prefill.cu``): the slash
  kernel's walk skips the last valid entry of every tile list (targets the
  checks of both slash functions, which share the walk);
- ``db_prefix_from_flags`` (``kernels/block_sparse_prefill.py``): the db
  wrapper hands the kernel ``tile_valid`` in place of the valid prefix
  (targets the db check on lists that are not valid-first, the only ones
  where the two differ);
- ``db_prefix_one_short`` (``kernels/block_sparse_prefill.py``): the valid
  prefix ends one entry early, ``arange(T) < nval - 1`` (targets the db
  checks; ``chip_smoke.py`` computes the prefix of db's plain version on
  its own);
- ``vertical_drop_last_chunk`` (``csrc/block_sparse_prefill.cu``): the
  vertical kernel never attends over the last 64-column unit of the sorted
  order that holds a valid column (nor past it);
- ``vertical_edge_one_unit_early``: the vertical walk of a q tile ends up
  to one 64-column unit early (a last tile of at most 64 columns to read is
  not visited);
- ``vertical_interior_one_unit_long``: the vertical kernel takes the
  interior prefix (unmasked tiles) one unit longer than the columns every
  row of the q tile sees;
- ``slash_vertical_unit_unmasked``: a slash unit inside the warpgroup's
  rows (past the pad, below the diagonal) skips the bit test of its
  vertical columns (the vertical partials' columns counted twice);
- ``slash_pad_unit_unmasked``: a slash unit across the pad takes only the
  bit test of the units inside the rows, its padding columns unmasked
  (targets the slash checks with a pad inside a 64-key unit);
- ``slash_neighbour_list_q_block_64``: warpgroup 1 of a q tile walks
  warpgroup 0's tile list, the neighbouring q-block's at q_block 64
  (targets the slash checks at q_block 64);
- ``h2o_stats_pad_edge_interior`` / ``h2o_colsum_pad_edge_interior``
  (``csrc/h2o_scores.cu``): the tile holding the pad edge counts as
  interior in the stats kernel (its padding columns go unmasked) / the
  colsum kernel (its padding rows, m = float32.min and l = 0, go unhidden);
  each targets its kernel's checks with a pad inside a 128-row tile;
- ``h2o_stats_no_causal_block``: the stats kernel drops the W x W block's
  causal mask (targets the check whose W x W block spans two tiles; with
  W = 8 a row gains at most 7 of thousands of terms);
- ``h2o_colsum_padding_rows_counted``: colsum's producer leaves every
  fourth padding row of the pad-edge tile unhidden (targets the checks
  with a pad inside a tile);
- ``h2o_stats_skip_last_key_tile`` / ``h2o_colsum_skip_last_q_tile``: the
  stats kernel's blocks stop before their last key tile / the colsum
  kernel's before their last query tile (unless it is their only one);
- ``h2o_release_before_products`` (both kernels' shared walk): a consumer
  releases a ring stage as soon as its tile has landed, before the
  products that read it are issued, so the producer refills a stage that
  wgmma may still read (and colsum's offsets beside it) (targets the 8k
  and 32k checks: the short ones' blocks walk no more tiles than the ring
  holds);
- ``partials_drop_last_k_tile`` (``csrc/flash_prefill.cu``): the partials
  entry of the wgmma kernel skips the last key tile of every block (the
  self tile's diagonal, a history tile's last 128 keys);
- ``flash_q_start_edge`` (``csrc/flash_prefill.cu``): the wgmma kernel's
  causal edge one key tile early (its last row taken as 128 rows before
  the block's last), at every q_start;
- ``flash_drop_diagonal_tile`` (``csrc/flash_prefill.cu``): the one-pass
  entry of the wgmma kernel skips each q tile's last key tile (the
  diagonal; targets check_flash);
- ``flash_interior_on_pad_edge`` (``csrc/flash_prefill.cu``): the key tile
  holding a row's pad edge counts as interior, so its pad keys go unmasked
  (targets check_flash);
- ``flash_wrong_stage`` (``csrc/flash_prefill.cu``): the consumer
  warpgroups read the K stage before the one they waited on (targets
  check_flash);
- ``row_max_skip_first_k_tile`` (``csrc/flash_prefill.cu``): pass A of the
  two-pass schedule starts one key tile late (the first tile past the pad
  never enters a row's max);
- ``row_max_drops_last_unit``: pass A's consumers skip the last 64-key unit
  of each block's walk (the diagonal tile's second half);
- ``row_max_no_window_mask``: pass A's edge units leave the window edge
  unmasked (targets the checks with a sliding window);
- ``flash_no_window_mask`` (``csrc/flash_prefill.cu``): the wgmma
  kernel's edge tiles leave the window edge unmasked (its walk still
  starts at the window edge's tile; targets Mistral's windowed checks
  whose rows the window cuts);
- ``partials_no_window`` (``csrc/flash_prefill.cu``): the partials entry
  drops its window argument (targets Mistral's windowed partials);
- ``pass_b_skip_diagonal_tile`` (``csrc/flash_prefill.cu``): pass B (the
  wgmma kernel's pass-B entry) skips each q tile's last key tile (the
  diagonal);
- ``pass_b_unclamped_max`` (``csrc/flash_prefill.cu``): pass B reads pass
  A's m without the float32.min / 2 clamp, so a row that is all padding
  (m = float32.min) takes p = 1 on its masked keys instead of 0;
- ``gemma_flash_cap_skipped`` (``csrc/flash_prefill.cu``): the wgmma
  kernel leaves Gemma-2's logits uncapped (base 2 still), targeting
  ``phase_gemma_kernels``' capped one-pass, q_start, partials and pass-B
  checks; ``gemma_flash_log2e_before_tanh``: log2(e) folded into q before
  the tanh (the cap then applied in base 2 at cap, not cap * log2 e);
  ``gemma_flash_v_first_half``: at D = 256 both 128-channel halves of O
  read V's first 128 channels;
- ``gemma_window_on_full_layer`` (``models/llama.py``): the prefill applies
  the sliding window on Gemma-2's full-attention layers too, caught by
  ``phase_gemma_reference`` (the port's depth-2 prefill against the
  harness's own plain Gemma-2 forward);
- ``gemma_decode_cap_skipped`` (``csrc/decode_attn.cu``): the decode
  kernel leaves the logits uncapped (``phase_gemma_kernels``' capped
  decode checks);
- ``gemma_h2o_cap_skipped`` (``csrc/h2o_scores.cu``): both H2O kernels
  leave Gemma-2's logits uncapped (base 2 still; ``phase_gemma_kernels``'
  capped H2O checks); ``gemma_h2o_log2e_before_tanh``: log2(e) taken
  before the tanh (cap * tanh(s log2(e) / cap));
- ``gemma_slash_cap_skipped`` (``csrc/block_sparse_prefill.cu``): the
  block-sparse kernels leave the logits uncapped (targets the capped
  slash checks); ``gemma_sparse_mask_before_cap``: at D = 256 the masks
  come before the cap, so a masked logit becomes -cap and counts (a row
  that sees no key of the slash walk, as the first real rows whose only
  keys are the vertical sinks, gets m = -cap, l > 0: targets the capped
  slash checks); ``gemma_vertical_v_high_dropped``: at D = 256 the P V
  product leaves V's second 128 channels out (targets the D = 256
  vertical checks);
- ``fold_skip_first_k_group`` (``csrc/quant_region.cuh``): the group
  kernel's kFold mode folds the query of each split's first staged K group
  on every bit-plane with 1 instead of the group's scale;
- ``region_drop_plane`` (``csrc/quant_region.cuh``): the group kernel reads
  the last bit-plane's V codes as 0;
- ``region_unit_scale_first_k_group`` (``csrc/quant_region.cuh``): the
  group kernel's kF32 mode stages 1 for the K scale of K group 0;
- ``region_wrong_plane_k_group`` (``csrc/quant_region.cuh``): the group
  kernel stages, for each bit-plane's columns, the K groups of the next
  plane's slots (targets the checks of 2- and 4-bit codes);
- ``region_cluster_drops_last_split`` (``csrc/quant_region.cuh``): the
  cluster merge of the group kernel leaves the last split out of the sums
  (targets the checks of 2 to 4 splits);
- ``region_merge_drops_last_split`` (``csrc/quant_region.cuh``): the merge
  kernel after the group kernel leaves the last split out of the sums
  (targets the checks of more than 4 splits);
- ``region_window_restages_first`` (``csrc/quant_region.cuh``): where a
  split's K tables take several stagings (a long region on one split),
  each later staging reloads the first window's K groups (targets the
  checks of more than one staging);
- ``region_skip_first_tail_item`` (``csrc/quant_region.cuh``): the group
  kernel never attends over the first 32 slots of the bf16 decode tail;
- ``region_skip_last_tail_item`` (``csrc/quant_region.cuh``): the group
  kernel never attends over the tail's last 32-slot item;
- ``decode_merge_drops_last_split`` (``csrc/decode_attn.cu``): the merge
  kernel of the split decode leaves the last split out of the sums
  (targets the checks of more than 4 splits);
- ``decode_cluster_drops_last_split`` (``csrc/decode_attn.cu``): the same
  fault in the cluster merge (targets the checks of 2 to 4 splits);
- ``decode_drops_partial_tile`` (``csrc/decode_attn.cu``): the split kernel
  treats the slots of a tile cut short by S as past S (targets the
  random-mask checks whose S is no multiple of the 64-slot tile);
- ``decode_skips_all_masked_row`` (``csrc/decode_attn.cu``): a split with no
  visible slot in a row masked everywhere attends over nothing instead of
  all its slots (tile skipping applied to that row: targets the random-mask
  checks, each of which masks one row everywhere).
- ``decode_g7_reads_g8_rows`` (``csrc/decode_attn.cu``): at G = 7 the
  split kernel reads each region's query heads at a stride of 8 rows, as
  if G were 8 (checked by ``phase_qwen_kernels``; targets its G = 7 decode
  checks, whose regions past the first read another region's heads);
- ``pa_g7_reads_g8_rows`` (``csrc/quant_region.cuh``): the same fault in
  the pa split kernel's folded queries (targets its G = 7 checks);
- ``int4_cluster_drops_last_rank`` (``csrc/int4_matmul.cu``): rank 0 of
  the int4 kernel's cluster leaves the last rank's partial out of its sum
  (targets the int4 checks of more than one rank);
- ``int4_last_group_unscaled``: the last group of the in-dim takes scale 1
  on its low-nibble columns (targets the grouped int4 checks);
- ``int4_span1_nibbles_swapped``: at span 1 a byte's low nibble is written
  to its high nibble's column and back (targets the span-1 int4 checks);
- ``int4_drops_last_stage``: the consumers skip the products of each
  slice's last ring stage (waiting for it and releasing it as before);
- ``int4_x_row_0_for_all``: every x row's B fragment reads x row 0
  (targets the int4 checks of more than one row).
A check whose output is not finite counts as caught (err_over_tol inf).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "pyramidkv_tpu_torch"
#: (source file in the package, chip_smoke phase that checks it)
KIVI = ("csrc/quant_region.cuh", "phase_kv_quant_kernels")
DECODE = ("csrc/decode_attn.cu", "phase_decode_kernels")
H2O = ("csrc/h2o_scores.cu", "phase_h2o_chunk_kernels")
BSP = ("csrc/block_sparse_prefill.cu", "phase_minference_kernels")
BSP_PY = ("kernels/block_sparse_prefill.py", "phase_minference_kernels")
MM = ("csrc/int4_matmul.cu", "phase_mm_kernels")
QWEN_DECODE = ("csrc/decode_attn.cu", "phase_qwen_kernels")
QWEN_KIVI = ("csrc/quant_region.cuh", "phase_qwen_kernels")
GEMMA_FLASH = ("csrc/flash_prefill.cu", "phase_gemma_kernels")
GEMMA_BSP = ("csrc/block_sparse_prefill.cu", "phase_gemma_kernels")
GEMMA_KIVI = ("csrc/quant_region.cuh", "phase_gemma_region_kernels")
D32 = "phase_trained_kernel_checks"


def _d32(check):
    """The D = 32 checks of one kernel (the trained checkpoint's)."""
    return lambda r: r["check"] == check and r.get("D") == 32


def _capped_h2o(r):
    return r["check"] in ("h2o_row_stats", "h2o_colsum") and r.get("softcap")


def _capped_slash(r):
    return r["check"] == "slash_tile_attention" and r.get("softcap")


def _group(r):
    return r["check"] != "quant_fused_attention_pa"


def _pa(r):
    return r["check"] == "quant_fused_attention_pa"


def _capped_region(r):
    """A KIVI region check at D = 256 under the cap."""
    return r["check"] in (
        "quant_decode_attention", "quant_decode_attention_tiled",
        "quant_fused_attention_group", "quant_fused_attention_pa") and (
        r.get("D") == 256 and bool(r.get("softcap")))


def _int4(r):
    return r["check"] in ("int4_matmul", "int4_matmul_dma")


def _window_cut(r):
    """Mistral's one-pass and partials checks whose rows the window cuts
    (the 8k batch's chunks 0 and 1 hold rows below the window: no key is
    outside it)."""
    return (r["check"] in ("flash_causal_attention",
                           "flash_causal_attention (q_start)",
                           "flash_attention_partials")
            and bool(r.get("window"))
            and not r["case"].startswith(("8k batch chunk 0",
                                          "8k batch chunk 1")))


def _capped_flash(r):
    """Gemma-2's capped one-pass, q_start, partials and pass-B flash checks
    (the wgmma kernel's modes; pass A caps its maxes on its own)."""
    return (r["check"] in ("flash_causal_attention",
                           "flash_causal_attention (q_start)",
                           "flash_attention_partials", "flash_pass_b")
            and bool(r.get("softcap")))


def _pad_in_tile(r):
    """An H2O check with a batch row whose pad lies inside a 128-row tile."""
    return any((r["N"] - t) % 128 for t in r["true_len"])


#: name -> (source, chip_smoke phase, targeted checks (None: all; a tuple
#: of check names, or a predicate on a check's record), old, new)
MUTANTS = {
    "drop_plane": (*KIVI, _pa,
        ("const uint32_t y00 = (x00 >> (f * FB)) & M8, y01 = (x01 >> (f * "
         "FB)) & M8;",
         "const uint32_t y10 = (x10 >> (f * FB)) & M8, y11 = (x11 >> (f * "
         "FB)) & M8;"),
        ("const uint32_t y00 = f == NF - 1 ? 0u : (x00 >> (f * FB)) & M8, "
         "y01 = f == NF - 1 ? 0u : (x01 >> (f * FB)) & M8;",
         "const uint32_t y10 = f == NF - 1 ? 0u : (x10 >> (f * FB)) & M8, "
         "y11 = f == NF - 1 ? 0u : (x11 >> (f * FB)) & M8;")),
    "drop_chunk": (*KIVI, _pa,
        "    issue(i + PA_STAGES - 1);\n    const uint8_t* st",
        "    issue(i + PA_STAGES - 1);\n    if (warp == 1 && i == 0) continue;"
        "\n    const uint8_t* st"),
    "pa_last_unit_reads_unwaited_stage": (*KIVI, _pa,
        "const uint8_t* st = ring + (i % PA_STAGES) * STAGE;",
        "const uint8_t* st = ring + ((i + (i == nu - 1)) % PA_STAGES) * "
        "STAGE;"),
    "pa_plane_folds_next_group": (
        *KIVI, lambda r: _pa(r) and r["k_groups"] > 1,
        "const size_t o = ((size_t)bk * D + ch) * a.NG + p * gpl + gsp;",
        "const size_t o = ((size_t)bk * D + ch) * a.NG + ((p + 1) % PER) * "
        "gpl + gsp;"),
    "pa_merge_drops_last_split": (
        *KIVI, lambda r: _pa(r) and r["nsplit"] > 1,
        "  for (int s = 0; s < nsplit; ++s) {\n    const size_t r = ",
        "  for (int s = 0; s < nsplit - 1; ++s) {\n    const size_t r = "),
    "slash_drop_last_tile": (
        *BSP, ("slash_tile_attention", "slash_tile_attention_db"),
        "            if (!ok) continue;",
        "            if (!ok || t + 1 == a.T || !val) continue;"),
    "db_prefix_from_flags": (
        *BSP_PY, lambda r: r["check"] == "slash_tile_attention_db"
        and r["case"] == "lists not valid-first",
        "    prefix = valid_prefix(tile_valid)\n",
        "    prefix = tile_valid\n"),
    "db_prefix_one_short": (
        *BSP_PY, ("slash_tile_attention_db",),
        "device=tile_valid.device) < nval)",
        "device=tile_valid.device) < nval - 1)"),
    "vertical_drop_last_chunk": (
        *BSP, ("vertical_attention_partials",),
        "        for (int c0 = 0; c0 < n_last; c0 += BK) emit(c0, c0 + UNIT, "
        "row_wgs);",
        "        const int vlast = (a.counts[((size_t)bh * a.nqt + a.nqt - 1) "
        "* 2 + 1] - 1) / UNIT * UNIT;\n"
        "        for (int c0 = 0; c0 < min(n_last, vlast); c0 += BK) emit(c0, "
        "c0 + UNIT < vlast ? c0 + UNIT : -1, row_wgs);"),
    "vertical_edge_one_unit_early": (
        *BSP, ("vertical_attention_partials",),
        "for (int c0 = 0; c0 < n_last; c0 += BK)",
        "for (int c0 = 0; c0 < n_last - UNIT; c0 += BK)"),
    "vertical_interior_one_unit_long": (
        *BSP, ("vertical_attention_partials",),
        "if (tile_k0[st][0] + BK > n_first)",
        "if (tile_k0[st][0] + BK > n_first + UNIT)"),
    "slash_vertical_unit_unmasked": (
        *BSP, ("slash_tile_attention",),
        "          else if (w != 0ull)",
        "          else if (false && w != 0ull)"),
    "slash_pad_unit_unmasked": (
        *BSP, lambda r: r["check"] == "slash_tile_attention" and any(
            (r["N"] - t) % 64 for t in r["true_len"]),
        "          if (!(k0 >= pad && k0 + UNIT - 1 <= r_lo))",
        "          if (!(k0 >= pad && k0 + UNIT - 1 <= r_lo) &&\n"
        "              !(k0 < pad && k0 + UNIT > pad))"),
    "slash_neighbour_list_q_block_64": (
        *BSP, lambda r: r["check"] == "slash_tile_attention"
        and r["q_block"] == 64,
        "qb1 = (q0 + 64) / a.q_block;",
        "qb1 = q0 / a.q_block;"),
    "h2o_stats_pad_edge_interior": (
        *H2O, lambda r: r["check"] == "h2o_row_stats" and _pad_in_tile(r),
        "  return r0 < pad || c0 < pad || c0 + BT > N || (rb <= r1 && c1 > rb);",
        "  return r0 < pad || c0 + BT > N || (rb <= r1 && c1 > rb);"),
    "h2o_colsum_pad_edge_interior": (
        *H2O, lambda r: r["check"] == "h2o_colsum" and _pad_in_tile(r),
        "      const bool edge = t0 < pad || t0 + BT > N;",
        "      const bool edge = t0 + BT > N;"),
    "h2o_stats_no_causal_block": (
        *H2O, lambda r: r["check"] == "h2o_row_stats" and r["W"] > 128,
        "    return EDGE && (min(r, c) < pad || c >= N || (r >= N - W && c > r))",
        "    return EDGE && (min(r, c) < pad || c >= N)"),
    "h2o_colsum_padding_rows_counted": (
        *H2O, lambda r: r["check"] == "h2o_colsum" and _pad_in_tile(r),
        "          exp_offset(mv.x, lv.x, edge && (r < pad || r >= N)),",
        "          exp_offset(mv.x, lv.x, edge && r >= N),"),
    "h2o_stats_skip_last_key_tile": (
        *H2O, ("h2o_row_stats",),
        "  const int ntiles = nqt - kt_first;  // every key tile to the end",
        "  const int ntiles = max(nqt - kt_first - 1, 1);"),
    "h2o_colsum_skip_last_q_tile": (
        *H2O, ("h2o_colsum",),
        "  const int ntiles = (N + BT - 1) / BT - qt_first;",
        "  const int ntiles = max((N + BT - 1) / BT - qt_first - 1, 1);"),
    "h2o_release_before_products": (
        *H2O, lambda r: r["case"] in ("8k", "32k"),
        ("  if (!(u & 1)) mbar_wait(&w.full[st], (i / STAGES) & 1);",
         "    mbar_arrive(&w.empty[(u >> 1) % STAGES]);  "
         "// the tile is read\n"),
        ("  if (!(u & 1)) {\n    mbar_wait(&w.full[st], (i / STAGES) & 1);\n"
         "    mbar_arrive(&w.empty[st]);\n  }", "")),
    "partials_drop_last_k_tile": (
        "csrc/flash_prefill.cu", "phase_h2o_chunk_kernels",
        ("flash_attention_partials",),
        "const int kt_last = hi / BK;",
        "const int kt_last = hi / BK - (MODE == kPartials ? 1 : 0);"),
    "flash_q_start_edge": (
        "csrc/flash_prefill.cu", "phase_h2o_chunk_kernels",
        ("flash_causal_attention (q_start)",),
        "const int hi = min(g1, N - 1);\n  const int kt_first = lo / BK;\n"
        "  const int kt_last",
        "const int hi = min(g1 - BK, N - 1);\n  const int kt_first = lo / "
        "BK;\n  const int kt_last"),
    "flash_drop_diagonal_tile": (
        "csrc/flash_prefill.cu", "phase_kernels", ("flash_causal_attention",),
        "const int kt_last = hi / BK;",
        "const int kt_last = hi / BK - (MODE == kOut ? 1 : 0);"),
    "flash_interior_on_pad_edge": (
        "csrc/flash_prefill.cu", "phase_kernels", ("flash_causal_attention",),
        "const bool interior = c0 >= pad && c0 + BK - 1 <= g0 &&",
        "const bool interior = c0 + BK > pad && c0 + BK - 1 <= g0 &&"),
    "flash_wrong_stage": (
        "csrc/flash_prefill.cu", "phase_kernels", ("flash_causal_attention",),
        "const uint32_t k_addr = kring_a + st * TILE_BYTES;",
        "const uint32_t k_addr = kring_a + ((st + STAGES - 1) % STAGES) * "
        "TILE_BYTES;"),
    "row_max_skip_first_k_tile": (
        "csrc/flash_prefill.cu", "phase_two_pass_kernels", ("flash_row_max",),
        "  const int kt_first = lo / BK;\n  const int ntiles = lo > hi ? 0 : "
        "hi / BK - kt_first + 1;",
        "  const int kt_first = lo / BK + 1;\n  const int ntiles = lo > hi ? "
        "0 : hi / BK - kt_first + 1;"),
    "row_max_drops_last_unit": (
        "csrc/flash_prefill.cu", "phase_two_pass_kernels", ("flash_row_max",),
        "  auto process = [&](const float (&s)[32], int u) {\n    const int "
        "cu",
        "  auto process = [&](const float (&s)[32], int u) {\n    if (u == 2 "
        "* ntiles - 1) return;\n    const int cu"),
    "row_max_no_window_mask": (
        "csrc/flash_prefill.cu", "phase_two_pass_kernels",
        lambda r: r["check"] == "flash_row_max" and r.get("window"),
        "          if (window > 0) ok = ok && r - c < window;\n",
        ""),
    "flash_no_window_mask": (
        "csrc/flash_prefill.cu", "phase_mistral_kernels", _window_cut,
        "        if (window > 0) ok = ok && row - col < window;\n"
        "        if (!ok) s[4 * j + e] = -INFINITY;",
        "        if (!ok) s[4 * j + e] = -INFINITY;"),
    "partials_no_window": (
        "csrc/flash_prefill.cu", "phase_mistral_kernels",
        lambda r: r["check"] == "flash_attention_partials",
        "nullptr, B, H, Hk, D, N, N, Nq, q_start,\n"
        "                                 window, scale",
        "nullptr, B, H, Hk, D, N, N, Nq, q_start,\n"
        "                                 0, scale"),
    "pass_b_skip_diagonal_tile": (
        "csrc/flash_prefill.cu", "phase_two_pass_kernels", ("flash_pass_b",),
        "const int kt_last = hi / BK;",
        "const int kt_last = hi / BK - (MODE == kPassB ? 1 : 0);"),
    "pass_b_unclamped_max": (
        "csrc/flash_prefill.cu", "phase_two_pass_kernels", ("flash_pass_b",),
        "? fmaxf(m_in[(size_t)bh * Nq + r0 + 8 * i], -FLT_MAX / 2)",
        "? m_in[(size_t)bh * Nq + r0 + 8 * i]"),
    "fold_skip_first_k_group": (
        *KIVI, lambda r: r["check"] == "quant_fused_attention_group",
        "const float ksv = grp < NG ? ksb[o] : 0.f;",
        "const float ksv = grp < NG ? (c % gpp == 0 ? 1.f : ksb[o]) : 0.f;"),
    "region_drop_plane": (
        *KIVI, _group,
        "const float cv = code_f((vw[h] >> (8 * k + p * NBITS)) & MASK);",
        "const float cv = p == PER - 1 ? 0.f : code_f((vw[h] >> (8 * k + p "
        "* NBITS)) & MASK);"),
    "region_unit_scale_first_k_group": (
        *KIVI, lambda r: r["check"] in ("quant_decode_attention",
                                        "quant_decode_attention_tiled"),
        "kt[c * QROW + pad_d(d)] = grp < NG ? ksb[o] : 0.f;",
        "kt[c * QROW + pad_d(d)] = grp < NG ? (grp == 0 ? 1.f : ksb[o]) : "
        "0.f;"),
    "region_wrong_plane_k_group": (
        *KIVI, lambda r: _group(r) and r["nbits"] < 8,
        "auto col_group = [&](int c) { return (wrow0 + (c / gpp) * W) / kg + "
        "c % gpp; };",
        "auto col_group = [&](int c) { return (wrow0 + ((c / gpp + 1) % PER) "
        "* W) / kg + c % gpp; };"),
    "region_cluster_drops_last_split": (
        *KIVI, lambda r: _group(r) and 1 < r["nsplit"] <= 4,
        "for (int r = 0; r < nsplit; ++r) {",
        "for (int r = 0; r < nsplit - 1; ++r) {"),
    "region_merge_drops_last_split": (
        *KIVI, lambda r: _group(r) and r["nsplit"] > 4,
        "const float f = ws_m[row] <= NEG / 2 ? 0.f : expf(ws_m[row] - mx);",
        "const float f = s == nsplit - 1 || ws_m[row] <= NEG / 2 ? 0.f : "
        "expf(ws_m[row] - mx);"),
    "region_window_restages_first": (
        *KIVI, lambda r: _group(r) and (r["windows"] or 1) > 1,
        "      stage_tables(wrow0);\n      __syncthreads();",
        "      stage_tables(row0);\n      __syncthreads();"),
    "region_skip_first_tail_item": (
        *KIVI, _group,
        "const bool vis = h0 + lane < ntail && twords[h0 + lane] != 0;",
        "const bool vis = h0 + lane < ntail && twords[h0 + lane] != 0 && "
        "h0 + lane > 0;"),
    "region_skip_last_tail_item": (
        *KIVI, _group,
        "const bool vis = h0 + lane < ntail && twords[h0 + lane] != 0;",
        "const bool vis = h0 + lane < ntail - 1 && twords[h0 + lane] != 0;"),
    "decode_merge_drops_last_split": (
        *DECODE, lambda r: r["nsplit"] > 4,
        "for (int s = warp; s < nsplit; s += 4) {",
        "for (int s = warp; s < nsplit - 1; s += 4) {"),
    "decode_cluster_drops_last_split": (
        *DECODE, lambda r: 1 < r["nsplit"] <= 4,
        "for (int r = 0; r < nsplit; ++r) {",
        "for (int r = 0; r < nsplit - 1; ++r) {"),
    "decode_drops_partial_tile": (
        *DECODE, lambda r: r["S"] % 64 != 0 and not r["case"].startswith(
            "engine"),
        "const bool in_row = r0 + r < s1;",
        "const bool in_row = r0 + r < s1 && r0 + TILE <= s1;"),
    "decode_skips_all_masked_row": (
        *DECODE, lambda r: not r["case"].startswith("engine"),
        "    n = found ? 0 : ntiles;",
        "    n = 0;"),
    "decode_g7_reads_g8_rows": (
        *QWEN_DECODE, lambda r: (r["check"] == "decode_attention"
                                 and r["H"] // r["Hk"] == 7),
        "const __nv_bfloat16* qg = q + ((size_t)bk * G + g) * D;",
        "const __nv_bfloat16* qg = q + (G == 7 ? ((size_t)bk * 8 + g) % "
        "((size_t)gridDim.x * G) : (size_t)bk * G + g) * D;"),
    "pa_g7_reads_g8_rows": (
        *QWEN_KIVI, lambda r: _pa(r) and r["G"] == 7,
        "qraw[i][g] = a.q[((size_t)bk * G + g) * D + ch];",
        "qraw[i][g] = a.q[(G == 7 ? ((size_t)bk * 8 + g) % ((size_t)gridDim.x"
        " * G) : (size_t)bk * G + g) * D + ch];"),
    "gemma_flash_cap_skipped": (
        *GEMMA_FLASH, _capped_flash,
        "for (int i = 0; i < NS; ++i) s[i] = cap_logit(s[i], inv_cap, cap2);",
        "for (int i = 0; i < NS; ++i) s[i] = s[i] * LOG2E;"),
    "gemma_flash_log2e_before_tanh": (
        *GEMMA_FLASH, _capped_flash,
        ("const float scale_q = cap > 0.f ? scale : scale * LOG2E;",
         "const float cap2 = cap * LOG2E;"),
        ("const float scale_q = scale * LOG2E;",
         "const float cap2 = cap;")),
    "gemma_flash_v_first_half": (
        *GEMMA_FLASH, _capped_flash,
        "sw128_desc(v_addr + h * 2 * KV_BOX + kk * 16 * 128, KV_BOX,",
        "sw128_desc(v_addr + kk * 16 * 128, KV_BOX,"),
    "gemma_window_on_full_layer": (
        "models/llama.py", "phase_gemma_reference", ("gemma_reference",),
        "            win = spec.layer_window(li)\n",
        "            win = spec.sliding_window\n"),
    "gemma_h2o_cap_skipped": (
        "csrc/h2o_scores.cu", "phase_gemma_kernels", _capped_h2o,
        "  return tanh_approx(s * inv_cap) * cap2;",
        "  return s * LOG2E;"),
    "gemma_h2o_log2e_before_tanh": (
        "csrc/h2o_scores.cu", "phase_gemma_kernels",
        lambda r: r["check"] == "h2o_row_stats" and r.get("softcap"),
        "  return tanh_approx(s * inv_cap) * cap2;",
        "  return tanh_approx(s * LOG2E * inv_cap) * (cap2 / LOG2E);"),
    "gemma_slash_cap_skipped": (
        *GEMMA_BSP, _capped_slash,
        "    for (int i = 0; i < NS; ++i) s[i] = tanh_approx(s[i] * inv_cap) "
        "* cap;",
        "    for (int i = 0; i < NS; ++i) s[i] = s[i];"),
    "gemma_sparse_mask_before_cap": (
        *GEMMA_BSP, _capped_slash,
        ("    sp::cap_tile<CAP>(s, inv_cap, a.cap);\n",
         "    mbar_arrive(&k_empty[st]);\n    float alpha[2];\n"),
        ("", "    sp::cap_tile<CAP>(s, inv_cap, a.cap);\n"
         "    mbar_arrive(&k_empty[st]);\n    float alpha[2];\n")),
    "gemma_vertical_v_high_dropped": (
        *GEMMA_BSP, lambda r: (r["check"] == "vertical_attention_partials"
                               and r.get("D") == 256),
        "    for (int h = 0; h < 2; ++h)\n      wgmma_rs(o[h], p[4 * kk]",
        "    for (int h = 0; h < 1; ++h)\n      wgmma_rs(o[h], p[4 * kk]"),
    "gemma_decode_cap_skipped": (
        "csrc/decode_attn.cu", "phase_gemma_kernels",
        lambda r: r["check"] == "decode_attention" and r.get("softcap"),
        "const float y = CAP ? tanh_approx(x * scale_cap) * cap2 : x * scale2;",
        "const float y = x * scale2;"),
    "gemma_kfold_cap_skipped": (
        *GEMMA_KIVI, lambda r: _capped_region(r) and r["check"]
        == "quant_fused_attention_group",
        "            if constexpr (CAP) x = cap_logit(x, a.softcap, inv_cap);\n"
        "            s[p][g] = ",
        "            if constexpr (CAP && MODE != kFold)\n"
        "              x = cap_logit(x, a.softcap, inv_cap);\n"
        "            s[p][g] = "),
    "gemma_kf32_cap_skipped": (
        *GEMMA_KIVI, lambda r: (_capped_region(r) and not r["mm_bf16"]
                                and r["check"] in (
                                    "quant_decode_attention",
                                    "quant_decode_attention_tiled")),
        "            if constexpr (CAP) x = cap_logit(x, a.softcap, inv_cap);\n"
        "            s[p][g] = ",
        "            if constexpr (CAP && MODE != kF32)\n"
        "              x = cap_logit(x, a.softcap, inv_cap);\n"
        "            s[p][g] = "),
    "gemma_pa_cap_skipped": (
        *GEMMA_KIVI, lambda r: _capped_region(r) and _pa(r),
        "          if constexpr (CAP) y = cap_logit(y, a.softcap, inv_cap);\n",
        ""),
    "gemma_region_mask_before_cap": (
        *GEMMA_KIVI, lambda r: _capped_region(r) and _group(r),
        "            if constexpr (CAP) x = cap_logit(x, a.softcap, inv_cap);\n"
        "            s[p][g] = !in ? -INFINITY : !valid ? NEG : x;",
        "            s[p][g] = !in ? -INFINITY : !valid ? NEG : x;\n"
        "            if constexpr (CAP)\n"
        "              if (in) s[p][g] = cap_logit(s[p][g], a.softcap, "
        "inv_cap);"),
    "gemma_fold_scale_after_bf16": (
        *GEMMA_KIVI, lambda r: (_capped_region(r) and r["check"]
                                == "quant_fused_attention_group"
                                and r["scale"] != 1 / 16),
        "              bf16_round(__bfloat162float(qg[g * D + d]) * a.scale * "
        "ksv);",
        "              bf16_round(__bfloat162float(qg[g * D + d]) * ksv) * "
        "a.scale;"),
    "gemma_region_v_high_dropped": (
        *GEMMA_KIVI, lambda r: _capped_region(r) and _group(r),
        "          vw[h] = *reinterpret_cast<const uint32_t*>(vst + rv * Dp + "
        "lane * VPL + 4 * h);",
        "          vw[h] = D == 256 && lane >= 16 ? 0u : "
        "*reinterpret_cast<const uint32_t*>(vst + rv * Dp + lane * VPL + 4 "
        "* h);"),
    "gemma_pa_v_high_dropped": (
        *GEMMA_KIVI, lambda r: _capped_region(r) and _pa(r),
        "        vw[j][h] = *reinterpret_cast<const uint4*>(",
        "        vw[j][h] = D == 256 && gid >= 4 ? make_uint4(0u, 0u, 0u, 0u) "
        ": *reinterpret_cast<const uint4*>("),
    "gemma_carry_window_every_layer": (
        "models/chunked_prefill.py", "phase_gemma_reference",
        ("gemma_reference_carry",),
        "        win = spec.layer_window(li)\n        # the history",
        "        win = spec.sliding_window\n        # the history"),
    "int4_cluster_drops_last_rank": (
        *MM, lambda r: _int4(r) and r["cluster"] > 1,
        "for (int r = 1; r < nrank; ++r) v += src[r * psz + e];",
        "for (int r = 1; r < nrank - 1; ++r) v += src[r * psz + e];"),
    "int4_last_group_unscaled": (
        *MM, lambda r: _int4(r) and r["group_size"] > 0,
        "#pragma unroll\n  for (int i = 0; i < 8; ++i) {\n"
        "    acc[i][0] = fmaf(frag[i][0], s[i], acc[i][0]);",
        "  if ((grp + 1) * a.gs >= a.in_dim)\n"
        "    for (int e = 0; e < 8; ++e) s[e] = 1.f;\n"
        "#pragma unroll\n  for (int i = 0; i < 8; ++i) {\n"
        "    acc[i][0] = fmaf(frag[i][0], s[i], acc[i][0]);"),
    "int4_span1_nibbles_swapped": (
        *MM, lambda r: _int4(r) and r["span"] == 1,
        "return span == 1 ? 2 * j + nib :",
        "return span == 1 ? 2 * j + 1 - nib :"),
    "d32_flash_skips_diagonal_tile": (
        "csrc/flash_prefill.cu", D32, _d32("flash_causal_attention"),
        "  for (int kt = t_lo; kt <= t_hi; ++kt) {\n    __syncthreads();  // "
        "every warp is done with the previous tile",
        "  for (int kt = t_lo; kt < t_hi; ++kt) {\n    __syncthreads();  // "
        "every warp is done with the previous tile"),
    "d32_flash_drops_last_channels": (
        "csrc/flash_prefill.cu", D32, _d32("flash_causal_attention"),
        "#pragma unroll\n      for (int nt = 0; nt < 4; ++nt) {\n        "
        "const __nv_bfloat16* vr",
        "#pragma unroll\n      for (int nt = 0; nt < 3; ++nt) {\n        "
        "const __nv_bfloat16* vr"),
    "d32_h2o_stats_no_window_block": (
        "csrc/h2o_scores.cu", D32, _d32("h2o_row_stats"),
        "const bool hid = min(r, c) < pad || (r >= N - W && c > r);",
        "const bool hid = min(r, c) < pad;"),
    "d32_h2o_colsum_one_offset": (
        "csrc/h2o_scores.cu", D32, _d32("h2o_colsum"),
        "cs[i] += ex2(y0 - o.x) + ex2(y1 - o.y);",
        "cs[i] += ex2(y0 - o.x) + ex2(y1 - o.x);"),
    "d32_decode_lanes_read_one_chunk": (
        "csrc/decode_attn.cu", D32, _d32("decode_attention"),
        "reinterpret_cast<const uint2*>(ks + r * ROW_BYTES + c * 8);",
        "reinterpret_cast<const uint2*>(ks + r * ROW_BYTES + (c & 3) * 8);"),
    "d32_region_v_byte_of_lane_mod_16": (
        "csrc/quant_region.cuh", D32, _d32("quant_fused_attention_group"),
        "vw[0] = vst[rv * Dp + lane];",
        "vw[0] = vst[rv * Dp + (lane & 15)];"),
    "d32_region_tail_k_of_lane_0": (
        "csrc/quant_region.cuh", D32, _d32("quant_fused_attention_group"),
        "reinterpret_cast<const uint2*>(st + r * D * 2 + c * 8);",
        "reinterpret_cast<const uint2*>(st + r * D * 2);"),
    "int4_drops_last_stage": (
        *MM, _int4,
        "const int nks = (min(a.ks,",
        "const int nks = i == nst - 1 ? 0 : (min(a.ks,"),
    "int4_x_row_0_for_all": (
        *MM, lambda r: _int4(r) and r["rows"] > 1,
        "const __nv_bfloat16* xl = xs + g * xp + 2 * t;",
        "const __nv_bfloat16* xl = xs + 2 * t;"),
}
_RUN = """
import json, sys, torch, torch.nn.functional as F
import chip_smoke as cs
recs = []
cs.log = recs.append
cs.SPARSE_CASES = {k: v[:-1] + (False,) for k, v in cs.SPARSE_CASES.items()}
cs.GEMMA_SPARSE_CASES = {k: v[:-1] + (False,)
                         for k, v in cs.GEMMA_SPARSE_CASES.items()}
# the H2O picks' count is a measurement, not a check: no mutant's verdict
# reads it
cs.count_h2o_picks = lambda *a, **kw: None
# a mutant is caught or not whatever the times: each timed call runs once
# and reads 1 ms
cs.time_ms = lambda torch, fn, reps, warmup=1: (fn(), 1.0)[1]
cs.graph_ms = lambda torch, fn, reps: (fn(), 1.0)[1]
getattr(cs, sys.argv[1])(torch, F, torch.device("cuda", 0))
def finite(x):
    return x if x == x else float("inf")  # NaN: not a finite output
print(json.dumps([{**{k: r.get(k) for k in ("check", "case", "H", "Hk", "G",
                                            "S", "nsplit",
                                            "kernels_per_call", "nbits",
                                            "windows", "N", "W",
                                            "true_len", "k_groups",
                                            "window", "q_block", "rows",
                                            "group_size", "cluster",
                                            "span", "D", "softcap",
                                            "scale", "mm_bf16")},
                   "err_over_tol": finite(r["err_over_tol"])}
                  for r in recs if "err_over_tol" in r]))
"""


def mutated(name: str) -> str:
    """The text of a mutant's source file with its edits applied (each
    edit's old text found exactly once)."""
    source, _, _, old, new = MUTANTS[name]
    with open(os.path.join(ROOT, PKG, source)) as f:
        src = f.read()
    # old and new: one text edit, or tuples of several
    for o, n in [(old, new)] if isinstance(old, str) else zip(old, new):
        assert src.count(o) == 1, name
        src = src.replace(o, n)
    return src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log", help="append the JSON result lines to this file")
    ap.add_argument("--only", help="comma-separated prefixes: run only the "
                    "mutants whose names start with one of them")
    args = ap.parse_args()
    names = [n for n in MUTANTS if not args.only
             or n.startswith(tuple(args.only.split(",")))]
    texts = {n: mutated(n) for n in names}  # every edit applies, up front
    failed = False
    for name in names:
        source, phase, targets, _, _ = MUTANTS[name]
        with tempfile.TemporaryDirectory() as tmp:
            shutil.copytree(os.path.join(ROOT, PKG), os.path.join(tmp, PKG),
                            ignore=shutil.ignore_patterns("_build"))
            shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp)
            # the minference checks read the per-head pattern config
            shutil.copytree(os.path.join(ROOT, "configs", "minference"),
                            os.path.join(tmp, "configs", "minference"))
            # the D = 32 checks take the trained grid's pinned prompt
            os.makedirs(os.path.join(tmp, "tests"))
            shutil.copy(os.path.join(ROOT, "tests", "torch_trained_tokens.json"),
                        os.path.join(tmp, "tests"))
            with open(os.path.join(tmp, PKG, source), "w") as f:
                f.write(texts[name])
            res = subprocess.run([sys.executable, "-c", _RUN, phase],
                                 cwd=tmp, capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stderr[-3000:], file=sys.stderr)
            return 1
        recs = json.loads(res.stdout.strip().splitlines()[-1])
        hit = [r for r in recs if targets is None or (
            targets(r) if callable(targets) else r["check"] in targets)]
        main_r = [r["err_over_tol"] for r in hit
                  if not r["case"].startswith("short")]
        short_r = [r["err_over_tol"] for r in hit
                   if r["case"].startswith("short")]
        caught = bool(main_r) and min(main_r) > 1
        failed |= not caught
        line = json.dumps({"mutant": name, "source": source,
                           "caught": caught,
                           "min_err_over_tol_main": min(main_r),
                           "min_err_over_tol_short": (min(short_r)
                                                      if short_r else None),
                           "checks": recs})
        print(line, flush=True)
        if args.log:
            with open(args.log, "a") as f:
                f.write(line + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

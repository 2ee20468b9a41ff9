// vp9host.cpp — native VP9 host-side entropy decoder.
//
// The TPU-native framework's hot serial path (SURVEY.md §3.5 #1): bool
// decoding of headers, modes, motion vectors and transform coefficients,
// emitting the dense FramePlan tensors the device reconstruction consumes.
// A faithful native mirror of the validated Python layer in
// cuda_vp9_tpu/decoder/ (same structure, same normative semantics as
// vp9/decoder/{vp9_decodemv.c,vp9_detokenize.c,vp9_decodeframe.c}).
//
// Build: g++ -O3 -shared -fPIC -o libvp9host.so vp9host.cpp
// Binding: ctypes (cuda_vp9_tpu/native/__init__.py).

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <algorithm>
#include <atomic>
#include <thread>

#include "vp9_tables.h"

namespace {

// ------------------------------------------------------------ constants

enum {
  KEY_FRAME = 0,
  INTRA_FRAME = 0, LAST_FRAME = 1, GOLDEN_FRAME = 2, ALTREF_FRAME = 3,
  NONE_FRAME = -1,
  BLOCK_8X8 = 3, BLOCK_64X64 = 12,
  TX_4X4 = 0, TX_8X8 = 1, TX_16X16 = 2, TX_32X32 = 3,
  TX_MODE_SELECT = 4,
  DC_PRED = 0, TM_PRED = 9, NEARESTMV = 10, NEARMV = 11, ZEROMV = 12,
  NEWMV = 13,
  SINGLE_REFERENCE = 0, COMPOUND_REFERENCE = 1, REFERENCE_MODE_SELECT = 2,
  EIGHTTAP = 0, SWITCHABLE_FILTERS = 3, SWITCHABLE = 4,
  PARTITION_NONE = 0, PARTITION_HORZ = 1, PARTITION_VERT = 2,
  PARTITION_SPLIT = 3,
  SEG_LVL_ALT_Q = 0, SEG_LVL_ALT_LF = 1, SEG_LVL_REF_FRAME = 2,
  SEG_LVL_SKIP = 3,
  MAX_SEGMENTS = 8, MAX_PROB = 255, MAXQ = 255,
  MV_LOW = -(1 << 14), MV_UPP = 1 << 14,
  CS_SRGB = 7,
};

static const int kSegFeatureBits[4] = {8, 6, 2, 0};
static const int kSegFeatureSigned[4] = {1, 1, 0, 0};
static const int kSegFeatureMax[4] = {255, 63, 3, 0};
static const int kLiteralToFilter[4] = {1, 0, 2, 3};

// ------------------------------------------------------------ bool decoder

struct BoolDec {
  const uint8_t* data;
  int64_t pos, end;
  uint64_t value;   // left-justified window
  uint32_t range;
  int count;        // valid bits beyond top byte
  int64_t virt;     // synthesized zero bytes
  bool marker_bad;

  void init(const uint8_t* d, int64_t start, int64_t size) {
    data = d; pos = start; end = start + size;
    value = 0; range = 255; count = -8; virt = 0;
    fill();
    marker_bad = read(128) != 0;
  }
  void fill() {
    // bulk path: shift in 8*n bits with one unaligned big-endian load
    // (safe whenever a full 8-byte read fits before `end`)
    if (count >= 0 && count < 48 && pos + 8 <= end) {
      int n = (48 - count + 7) >> 3;  // bytes needed to reach count>=48
      uint64_t be;
      __builtin_memcpy(&be, data + pos, 8);
      be = __builtin_bswap64(be);
      value = (value << (8 * n)) | (be >> (64 - 8 * n));
      pos += n;
      count += 8 * n;
      return;
    }
    while (count < 48) {
      uint8_t b = 0;
      if (pos < end) b = data[pos++];
      else virt++;
      value = (value << 8) | b;
      count += 8;
    }
  }
  bool has_error() const { return virt * 8 > count + 8; }
  inline int read(int prob) {
    if (count < 8) fill();
    uint32_t split = 1 + (((range - 1) * (uint32_t)prob) >> 8);
    uint64_t bigsplit = (uint64_t)split << count;
    int bit;
    if (value >= bigsplit) {
      bit = 1; range -= split; value -= bigsplit;
    } else {
      bit = 0; range = split;
    }
    // renormalize into [128, 255]: range>=1, so clz gives the exact shift
    if (range < 128) {
      int shift = __builtin_clz(range) - 24;
      range <<= shift;
      count -= shift;
    }
    return bit;
  }
  inline int read_bit() { return read(128); }
  inline int read_literal(int n) {
    int v = 0;
    for (int i = 0; i < n; i++) v = (v << 1) | read_bit();
    return v;
  }
  inline int read_tree(const int16_t* tree, const uint8_t* probs) {
    int i = 0;
    do { i = tree[i + read(probs[i >> 1])]; } while (i > 0);
    return -i;
  }
};

// ------------------------------------------------------------ raw bits

struct BitReader {
  const uint8_t* data;
  int64_t bit, size_bits;
  void init(const uint8_t* d, int64_t size) {
    data = d; bit = 0; size_bits = size * 8;
  }
  int read_bit() {
    int64_t p = bit++;
    if (p >= size_bits) return 0;
    return (data[p >> 3] >> (7 - (p & 7))) & 1;
  }
  int f(int n) { int v = 0; while (n--) v = (v << 1) | read_bit(); return v; }
  int sf(int n) { int v = f(n); return read_bit() ? -v : v; }
  int64_t byte_offset() const { return (bit + 7) >> 3; }
  bool overrun() const { return bit > size_bits; }
};

// ------------------------------------------------------------ contexts

struct FrameContext {
  uint8_t y_mode[4][9];
  uint8_t uv_mode[10][9];
  uint8_t partition[16][3];
  uint8_t coef[4][2][2][6][6][3];
  uint8_t switchable_interp[4][2];
  uint8_t inter_mode[7][3];
  uint8_t intra_inter[4];
  uint8_t comp_inter[5];
  uint8_t comp_ref[5];
  uint8_t single_ref[5][2];
  uint8_t tx32[2][3], tx16[2][2], tx8[2][1];
  uint8_t skip[3];
  uint8_t mv_joints[3];
  uint8_t mv_sign[2];
  uint8_t mv_classes[2][10];
  uint8_t mv_class0[2][1];
  uint8_t mv_bits[2][10];
  uint8_t mv_class0_fp[2][2][3];
  uint8_t mv_fp[2][3];
  uint8_t mv_class0_hp[2];
  uint8_t mv_hp[2];

  void set_default() {
    memcpy(y_mode, default_y_mode, sizeof(y_mode));
    memcpy(uv_mode, default_uv_mode, sizeof(uv_mode));
    memcpy(partition, default_partition, sizeof(partition));
    memcpy(coef, default_coef_probs, sizeof(coef));
    memcpy(switchable_interp, default_switchable_interp,
           sizeof(switchable_interp));
    memcpy(inter_mode, default_inter_mode, sizeof(inter_mode));
    memcpy(intra_inter, default_intra_inter, sizeof(intra_inter));
    memcpy(comp_inter, default_comp_inter, sizeof(comp_inter));
    memcpy(comp_ref, default_comp_ref, sizeof(comp_ref));
    memcpy(single_ref, default_single_ref, sizeof(single_ref));
    memcpy(tx32, default_tx32, sizeof(tx32));
    memcpy(tx16, default_tx16, sizeof(tx16));
    memcpy(tx8, default_tx8, sizeof(tx8));
    memcpy(skip, default_skip, sizeof(skip));
    memcpy(mv_joints, default_mv_joints, sizeof(mv_joints));
    memcpy(mv_sign, default_mv_sign, sizeof(mv_sign));
    memcpy(mv_classes, default_mv_classes, sizeof(mv_classes));
    memcpy(mv_class0, default_mv_class0, sizeof(mv_class0));
    memcpy(mv_bits, default_mv_bits, sizeof(mv_bits));
    memcpy(mv_class0_fp, default_mv_class0_fp, sizeof(mv_class0_fp));
    memcpy(mv_fp, default_mv_fp, sizeof(mv_fp));
    memcpy(mv_class0_hp, default_mv_class0_hp, sizeof(mv_class0_hp));
    memcpy(mv_hp, default_mv_hp, sizeof(mv_hp));
  }
};

struct Counts {
  uint32_t y_mode[4][10];
  uint32_t uv_mode[10][10];
  uint32_t partition[16][4];
  uint32_t coef[4][2][2][6][6][4];
  uint32_t eob_branch[4][2][2][6][6];
  uint32_t switchable_interp[4][3];
  uint32_t inter_mode[7][4];
  uint32_t intra_inter[4][2];
  uint32_t comp_inter[5][2];
  uint32_t comp_ref[5][2];
  uint32_t single_ref[5][2][2];
  uint32_t tx32[2][4], tx16[2][3], tx8[2][2];
  uint32_t skip[3][2];
  uint32_t mv_joints[4];
  uint32_t mv_sign[2][2];
  uint32_t mv_classes[2][11];
  uint32_t mv_class0[2][2];
  uint32_t mv_bits[2][10][2];
  uint32_t mv_class0_fp[2][2][4];
  uint32_t mv_fp[2][4];
  uint32_t mv_class0_hp[2][2];
  uint32_t mv_hp[2][2];
  void clear() { memset(this, 0, sizeof(*this)); }
  // merge another tile's counts (POD of uint32 arrays; summed wordwise)
  void add(const Counts& o) {
    uint32_t* a = (uint32_t*)this;
    const uint32_t* b = (const uint32_t*)&o;
    for (size_t i = 0; i < sizeof(*this) / sizeof(uint32_t); i++) a[i] += b[i];
  }
};

// ------------------------------------------------------------ header state

struct LoopFilterParams {
  int filter_level = 0, sharpness = 0;
  int mode_ref_delta_enabled = 1, mode_ref_delta_update = 0;
  int ref_deltas[4] = {1, 0, -1, -1};
  int mode_deltas[2] = {0, 0};
};

struct Segmentation {
  int enabled = 0, update_map = 0, temporal_update = 0, abs_delta = 0;
  uint8_t tree_probs[7];
  uint8_t pred_probs[3];
  uint8_t feature_enabled[8][4];
  int16_t feature_data[8][4];
  void clear() {
    enabled = update_map = temporal_update = abs_delta = 0;
    memset(tree_probs, 255, sizeof(tree_probs));
    memset(pred_probs, 255, sizeof(pred_probs));
    memset(feature_enabled, 0, sizeof(feature_enabled));
    memset(feature_data, 0, sizeof(feature_data));
  }
  bool active(int seg, int feat) const {
    return enabled && feature_enabled[seg][feat];
  }
};

struct Header {
  int profile = 0, show_existing = 0, frame_to_show = -1;
  int frame_type = 0, show_frame = 1, error_resilient = 0, intra_only = 0;
  int reset_frame_context = 0;
  int bit_depth = 8, subsampling_x = 1, subsampling_y = 1, color_space = 1;
  int color_range = 0;
  int width = 0, height = 0, render_width = 0, render_height = 0;
  int refresh_frame_flags = 0;
  int ref_frame_idx[3] = {0, 0, 0};
  int ref_frame_sign_bias[4] = {0, 0, 0, 0};
  int allow_hp = 0, interp_filter = SWITCHABLE;
  int refresh_frame_context = 0, frame_parallel = 1, frame_context_idx = 0;
  int base_qindex = 0, y_dc_delta = 0, uv_dc_delta = 0, uv_ac_delta = 0;
  int lossless = 0;
  int log2_tile_cols = 0, log2_tile_rows = 0;
  int64_t uncompressed_size = 0, compressed_size = 0;
  int mi_rows = 0, mi_cols = 0;
  bool is_intra_only() const { return frame_type == KEY_FRAME || intra_only; }
};

struct CompressedHeader {
  int tx_mode = 0;
  int reference_mode = SINGLE_REFERENCE;
  int comp_fixed_ref = ALTREF_FRAME;
  int comp_var_ref[2] = {LAST_FRAME, GOLDEN_FRAME};
  bool allow_comp = false;
};

// ------------------------------------------------------------ plan output

struct PlanOut {
  int32_t ok;                 // 1 success, 0 corrupt/error
  int32_t show_existing, frame_to_show;
  int32_t frame_type, show_frame, intra_only;
  int32_t width, height, bit_depth, subsampling_x, subsampling_y;
  int32_t lossless, base_qindex;
  int32_t refresh_frame_flags;
  int32_t ref_frame_idx[3];
  int32_t interp_filter, allow_hp, reference_mode;
  int32_t log2_tile_cols, log2_tile_rows;
  int32_t mi_rows, mi_cols;
  int32_t lf_filter_level, lf_sharpness, lf_mode_ref_delta_enabled;
  int32_t lf_ref_deltas[4], lf_mode_deltas[2];
  int32_t seg_enabled, seg_abs_delta;
  int32_t seg_feature_enabled[8][4];
  int32_t seg_feature_data[8][4];
  // mi grid (row-major [mi_rows][mi_cols])
  int8_t* sb_type; int8_t* mode; int8_t* uv_mode; int8_t* tx_size;
  int8_t* skip; int8_t* segment_id; int8_t* interp; int8_t* ref0;
  int8_t* ref1;
  int32_t* mv;        // [r][c][2][2]
  int8_t* bmi_mode;   // [r][c][4]
  int32_t* bmi_mv;    // [r][c][4][2][2]
  uint8_t* seg_map;
  // block list [n][5]
  int32_t n_blocks;
  int32_t* blocks;
  // per plane token maps
  int32_t plane_w4[3], plane_h4[3];
  int32_t* eob_map[3];
  int64_t* off_map[3];
  int32_t* coeffs[3];
  int64_t coeff_len[3];
};

// ------------------------------------------------------------ decoder

struct Decoder {
  // persistent state
  FrameContext frame_contexts[4];
  LoopFilterParams lf;
  Segmentation seg;
  std::vector<uint8_t> seg_map_last;
  int seg_map_last_rows = 0, seg_map_last_cols = 0;
  std::vector<int32_t> prev_mv;   // [r*c*2*2]
  std::vector<int8_t> prev_ref;   // [r*c*2]
  int prev_rows = 0, prev_cols = 0;
  int ref_w[8] = {0}, ref_h[8] = {0};
  int last_frame_type = KEY_FRAME, last_show_frame = 0, last_intra_only = 0;
  int last_w = 0, last_h = 0;
  int bit_depth = 8, ss_x = 1, ss_y = 1;

  // per-frame
  Header hdr;
  CompressedHeader ch;
  FrameContext fc;
  Counts counts;
  bool use_counts = false;
  bool corrupted = false;
  bool use_prev_mvs = false;
  int mi_rows = 0, mi_cols = 0;

  // mi grid
  std::vector<int8_t> g_sb, g_mode, g_uv, g_tx, g_skip, g_seg, g_segp,
      g_filt, g_ref0, g_ref1;
  std::vector<int32_t> g_mv;       // [r][c][2][2]
  std::vector<int8_t> g_bmode;     // [r][c][4]
  std::vector<int32_t> g_bmv;      // [r][c][4][2][2]
  std::vector<uint8_t> seg_map_cur;
  std::vector<int32_t> cur_mv;
  std::vector<int8_t> cur_ref;

  // entropy ctx spanning the frame width (shared across tiles: tile
  // columns own disjoint index ranges).  Left contexts live in TileCtx.
  std::vector<uint8_t> above_ctx[3];
  std::vector<uint8_t> above_seg;
  int n_threads = 1;  // DecCfg.threads: tile-parallel parse when > 1

  // plan outputs
  std::vector<int32_t> blocks;
  std::vector<int32_t> eob_map[3];
  std::vector<int64_t> off_map[3];
  std::vector<int32_t> coeffs[3];
  int plane_w4[3], plane_h4[3];

  // per-frame derived
  int seg_dequant[2][8][2];   // [plane_type][seg][dc/ac]
  int tile_col_start_ = 0, tile_col_end_ = 0;

  // ======================================================= helpers

  inline int8_t* mi8(std::vector<int8_t>& v, int r, int c) {
    return &v[(size_t)r * mi_cols + c];
  }
  inline bool cell_is_inter(int r, int c) {
    return g_ref0[(size_t)r * mi_cols + c] > INTRA_FRAME;
  }
  inline bool cell_has_second(int r, int c) {
    return g_ref1[(size_t)r * mi_cols + c] > INTRA_FRAME;
  }

  // ======================================================= dsubexp

  static int inv_recenter_nonneg(int v, int m) {
    if (v > 2 * m) return v;
    return (v & 1) ? m - ((v + 1) >> 1) : m + (v >> 1);
  }
  static int decode_uniform(BoolDec& r) {
    const int m = (1 << 8) - 191;
    int v = r.read_literal(7);
    return v < m ? v : (v << 1) - m + r.read_bit();
  }
  static int decode_term_subexp(BoolDec& r) {
    if (!r.read_bit()) return r.read_literal(4);
    if (!r.read_bit()) return r.read_literal(4) + 16;
    if (!r.read_bit()) return r.read_literal(5) + 32;
    return decode_uniform(r) + 64;
  }
  static int inv_remap_prob(int v, int m) {
    v = inv_map_table[v];
    m--;
    if ((m << 1) <= MAX_PROB) return 1 + inv_recenter_nonneg(v, m);
    return MAX_PROB - inv_recenter_nonneg(v, MAX_PROB - 1 - m);
  }
  static void diff_update_prob(BoolDec& r, uint8_t* p) {
    if (r.read(252)) *p = (uint8_t)inv_remap_prob(decode_term_subexp(r), *p);
  }
  static void update_mv_prob(BoolDec& r, uint8_t* p) {
    if (r.read(252)) *p = (uint8_t)((r.read_literal(7) << 1) | 1);
  }

  // ======================================================= headers

  bool read_bitdepth_colorspace(BitReader& rb) {
    if (hdr.profile >= 2) hdr.bit_depth = rb.read_bit() ? 12 : 10;
    else hdr.bit_depth = 8;
    hdr.color_space = rb.f(3);
    if (hdr.color_space != CS_SRGB) {
      hdr.color_range = rb.read_bit();
      if (hdr.profile == 1 || hdr.profile == 3) {
        hdr.subsampling_x = rb.read_bit();
        hdr.subsampling_y = rb.read_bit();
        if (rb.read_bit()) return false;
      } else {
        hdr.subsampling_x = hdr.subsampling_y = 1;
      }
    } else {
      hdr.color_range = 1;
      if (hdr.profile == 1 || hdr.profile == 3) {
        hdr.subsampling_x = hdr.subsampling_y = 0;
        if (rb.read_bit()) return false;
      } else {
        return false;
      }
    }
    return true;
  }

  void setup_past_independence() {
    seg.clear();
    lf.ref_deltas[0] = 1; lf.ref_deltas[1] = 0;
    lf.ref_deltas[2] = -1; lf.ref_deltas[3] = -1;
    lf.mode_deltas[0] = lf.mode_deltas[1] = 0;
    // vp9_entropymode.c:467 — sign biases are zeroed, so an
    // error-resilient frame can never code compound prediction
    for (int i = 0; i < 4; i++) hdr.ref_frame_sign_bias[i] = 0;
    std::fill(seg_map_last.begin(), seg_map_last.end(), 0);
    if (hdr.frame_type == KEY_FRAME || hdr.error_resilient
        || hdr.reset_frame_context == 3) {
      for (int i = 0; i < 4; i++) frame_contexts[i].set_default();
    } else if (hdr.reset_frame_context == 2) {
      frame_contexts[hdr.frame_context_idx].set_default();
    }
    hdr.frame_context_idx = 0;
  }

  bool parse_uncompressed(const uint8_t* data, int64_t size) {
    BitReader rb; rb.init(data, size);
    hdr = Header();
    if (rb.f(2) != 2) return false;
    hdr.profile = rb.read_bit() | (rb.read_bit() << 1);
    if (hdr.profile > 2) hdr.profile += rb.read_bit();
    if (hdr.profile > 3) return false;
    hdr.show_existing = rb.read_bit();
    if (hdr.show_existing) {
      hdr.frame_to_show = rb.f(3);
      return true;
    }
    hdr.frame_type = rb.read_bit();
    hdr.show_frame = rb.read_bit();
    hdr.error_resilient = rb.read_bit();
    if (hdr.frame_type == KEY_FRAME) {
      if (rb.f(8) != 0x49 || rb.f(8) != 0x83 || rb.f(8) != 0x42) return false;
      if (!read_bitdepth_colorspace(rb)) return false;
      hdr.refresh_frame_flags = 0xFF;
      hdr.width = rb.f(16) + 1;
      hdr.height = rb.f(16) + 1;
      if (rb.read_bit()) { hdr.render_width = rb.f(16) + 1;
                           hdr.render_height = rb.f(16) + 1; }
    } else {
      hdr.intra_only = hdr.show_frame ? 0 : rb.read_bit();
      hdr.reset_frame_context = hdr.error_resilient ? 0 : rb.f(2);
      if (hdr.intra_only) {
        if (rb.f(8) != 0x49 || rb.f(8) != 0x83 || rb.f(8) != 0x42)
          return false;
        if (hdr.profile > 0) {
          if (!read_bitdepth_colorspace(rb)) return false;
        } else {
          hdr.bit_depth = 8; hdr.color_space = 1;
          hdr.subsampling_x = hdr.subsampling_y = 1;
        }
        hdr.refresh_frame_flags = rb.f(8);
        hdr.width = rb.f(16) + 1;
        hdr.height = rb.f(16) + 1;
        if (rb.read_bit()) { rb.f(16); rb.f(16); }
      } else {
        hdr.refresh_frame_flags = rb.f(8);
        for (int i = 0; i < 3; i++) {
          hdr.ref_frame_idx[i] = rb.f(3);
          hdr.ref_frame_sign_bias[LAST_FRAME + i] = rb.read_bit();
        }
        bool found = false;
        for (int i = 0; i < 3; i++) {
          if (rb.read_bit()) {
            hdr.width = ref_w[hdr.ref_frame_idx[i]];
            hdr.height = ref_h[hdr.ref_frame_idx[i]];
            found = true;
            break;
          }
        }
        if (!found) { hdr.width = rb.f(16) + 1; hdr.height = rb.f(16) + 1; }
        if (hdr.width <= 0 || hdr.height <= 0) return false;
        if (rb.read_bit()) { rb.f(16); rb.f(16); }
        hdr.allow_hp = rb.read_bit();
        hdr.interp_filter = rb.read_bit() ? SWITCHABLE
                                          : kLiteralToFilter[rb.f(2)];
        hdr.bit_depth = bit_depth;
        hdr.subsampling_x = ss_x;
        hdr.subsampling_y = ss_y;
      }
    }
    if (!hdr.error_resilient) {
      hdr.refresh_frame_context = rb.read_bit();
      hdr.frame_parallel = rb.read_bit();
    } else {
      hdr.refresh_frame_context = 0;
      hdr.frame_parallel = 1;
    }
    hdr.frame_context_idx = rb.f(2);
    hdr.mi_cols = (hdr.width + 7) >> 3;
    hdr.mi_rows = (hdr.height + 7) >> 3;

    if (hdr.is_intra_only() || hdr.error_resilient) {
      // ensure last seg map sized before clearing
      if ((int)seg_map_last.size()
          != hdr.mi_rows * hdr.mi_cols) {
        seg_map_last.assign((size_t)hdr.mi_rows * hdr.mi_cols, 0);
        seg_map_last_rows = hdr.mi_rows;
        seg_map_last_cols = hdr.mi_cols;
      }
      setup_past_independence();
    }

    // loop filter params
    lf.filter_level = rb.f(6);
    lf.sharpness = rb.f(3);
    lf.mode_ref_delta_update = 0;
    lf.mode_ref_delta_enabled = rb.read_bit();
    if (lf.mode_ref_delta_enabled) {
      lf.mode_ref_delta_update = rb.read_bit();
      if (lf.mode_ref_delta_update) {
        for (int i = 0; i < 4; i++)
          if (rb.read_bit()) lf.ref_deltas[i] = rb.sf(6);
        for (int i = 0; i < 2; i++)
          if (rb.read_bit()) lf.mode_deltas[i] = rb.sf(6);
      }
    }
    // quantization
    hdr.base_qindex = rb.f(8);
    hdr.y_dc_delta = rb.read_bit() ? rb.sf(4) : 0;
    hdr.uv_dc_delta = rb.read_bit() ? rb.sf(4) : 0;
    hdr.uv_ac_delta = rb.read_bit() ? rb.sf(4) : 0;
    hdr.lossless = hdr.base_qindex == 0 && hdr.y_dc_delta == 0
                   && hdr.uv_dc_delta == 0 && hdr.uv_ac_delta == 0;
    // segmentation
    seg.update_map = 0;
    seg.temporal_update = 0;
    seg.enabled = rb.read_bit();
    if (seg.enabled) {
      seg.update_map = rb.read_bit();
      if (seg.update_map) {
        for (int i = 0; i < 7; i++)
          seg.tree_probs[i] = rb.read_bit() ? rb.f(8) : 255;
        seg.temporal_update = rb.read_bit();
        for (int i = 0; i < 3; i++)
          seg.pred_probs[i] = seg.temporal_update
              ? (rb.read_bit() ? rb.f(8) : 255) : 255;
      }
      if (rb.read_bit()) {
        seg.abs_delta = rb.read_bit();
        for (int i = 0; i < MAX_SEGMENTS; i++) {
          for (int j = 0; j < 4; j++) {
            int data = 0;
            int en = rb.read_bit();
            seg.feature_enabled[i][j] = en;
            if (en) {
              int bits = kSegFeatureBits[j];
              if (bits) data = std::min(rb.f(bits), kSegFeatureMax[j]);
              if (kSegFeatureSigned[j] && rb.read_bit()) data = -data;
            }
            seg.feature_data[i][j] = data;
          }
        }
      }
    }
    // tile info
    int sb64 = (hdr.mi_cols + 7) >> 3;
    int min_log2 = 0;
    while ((64 << min_log2) < sb64) min_log2++;
    int max_log2 = 1;
    while ((sb64 >> max_log2) >= 4) max_log2++;
    max_log2--;
    int lg = min_log2;
    while (lg < max_log2) {
      if (rb.read_bit()) lg++;
      else break;
    }
    hdr.log2_tile_cols = lg;
    hdr.log2_tile_rows = rb.read_bit();
    if (hdr.log2_tile_rows) hdr.log2_tile_rows += rb.read_bit();
    hdr.compressed_size = rb.f(16);
    if (rb.overrun()) return false;
    hdr.uncompressed_size = rb.byte_offset();
    return true;
  }

  // ======================================================= compressed hdr

  void read_coef_probs_tx(BoolDec& r, uint8_t (*probs)[2][6][6][3]) {
    for (int i = 0; i < 2; i++)
      for (int j = 0; j < 2; j++)
        for (int k = 0; k < 6; k++)
          for (int l = 0; l < (k == 0 ? 3 : 6); l++)
            for (int m = 0; m < 3; m++)
              diff_update_prob(r, &probs[i][j][k][l][m]);
  }

  bool parse_compressed(const uint8_t* data) {
    BoolDec r;
    r.init(data, hdr.uncompressed_size, hdr.compressed_size);
    ch = CompressedHeader();
    if (hdr.lossless) {
      ch.tx_mode = 0;
    } else {
      ch.tx_mode = r.read_literal(2);
      if (ch.tx_mode == 3) ch.tx_mode += r.read_bit();
    }
    if (ch.tx_mode == TX_MODE_SELECT) {
      for (int i = 0; i < 2; i++) diff_update_prob(r, &fc.tx8[i][0]);
      for (int i = 0; i < 2; i++)
        for (int j = 0; j < 2; j++) diff_update_prob(r, &fc.tx16[i][j]);
      for (int i = 0; i < 2; i++)
        for (int j = 0; j < 3; j++) diff_update_prob(r, &fc.tx32[i][j]);
    }
    int max_tx = tx_mode_to_biggest_tx_size[ch.tx_mode];
    for (int t = 0; t <= max_tx; t++)
      if (r.read_bit()) read_coef_probs_tx(r, fc.coef[t]);
    for (int k = 0; k < 3; k++) diff_update_prob(r, &fc.skip[k]);
    if (!hdr.is_intra_only()) {
      for (int i = 0; i < 7; i++)
        for (int j = 0; j < 3; j++)
          diff_update_prob(r, &fc.inter_mode[i][j]);
      if (hdr.interp_filter == SWITCHABLE)
        for (int i = 0; i < 4; i++)
          for (int j = 0; j < 2; j++)
            diff_update_prob(r, &fc.switchable_interp[i][j]);
      for (int i = 0; i < 4; i++) diff_update_prob(r, &fc.intra_inter[i]);
      // reference mode
      const int* sb = hdr.ref_frame_sign_bias;
      ch.allow_comp = (sb[2] != sb[1]) || (sb[3] != sb[1]);
      if (ch.allow_comp) {
        ch.reference_mode = r.read_bit()
            ? (r.read_bit() ? REFERENCE_MODE_SELECT : COMPOUND_REFERENCE)
            : SINGLE_REFERENCE;
        if (sb[LAST_FRAME] == sb[GOLDEN_FRAME]) {
          ch.comp_fixed_ref = ALTREF_FRAME;
          ch.comp_var_ref[0] = LAST_FRAME; ch.comp_var_ref[1] = GOLDEN_FRAME;
        } else if (sb[LAST_FRAME] == sb[ALTREF_FRAME]) {
          ch.comp_fixed_ref = GOLDEN_FRAME;
          ch.comp_var_ref[0] = LAST_FRAME; ch.comp_var_ref[1] = ALTREF_FRAME;
        } else {
          ch.comp_fixed_ref = LAST_FRAME;
          ch.comp_var_ref[0] = GOLDEN_FRAME; ch.comp_var_ref[1] = ALTREF_FRAME;
        }
      } else {
        ch.reference_mode = SINGLE_REFERENCE;
      }
      if (ch.reference_mode == REFERENCE_MODE_SELECT)
        for (int i = 0; i < 5; i++) diff_update_prob(r, &fc.comp_inter[i]);
      if (ch.reference_mode != COMPOUND_REFERENCE)
        for (int i = 0; i < 5; i++) {
          diff_update_prob(r, &fc.single_ref[i][0]);
          diff_update_prob(r, &fc.single_ref[i][1]);
        }
      if (ch.reference_mode != SINGLE_REFERENCE)
        for (int i = 0; i < 5; i++) diff_update_prob(r, &fc.comp_ref[i]);
      for (int i = 0; i < 4; i++)
        for (int j = 0; j < 9; j++) diff_update_prob(r, &fc.y_mode[i][j]);
      for (int i = 0; i < 16; i++)
        for (int j = 0; j < 3; j++) diff_update_prob(r, &fc.partition[i][j]);
      // mv probs
      for (int j = 0; j < 3; j++) update_mv_prob(r, &fc.mv_joints[j]);
      for (int i = 0; i < 2; i++) {
        update_mv_prob(r, &fc.mv_sign[i]);
        for (int j = 0; j < 10; j++) update_mv_prob(r, &fc.mv_classes[i][j]);
        update_mv_prob(r, &fc.mv_class0[i][0]);
        for (int j = 0; j < 10; j++) update_mv_prob(r, &fc.mv_bits[i][j]);
      }
      for (int i = 0; i < 2; i++) {
        for (int j = 0; j < 2; j++)
          for (int k = 0; k < 3; k++)
            update_mv_prob(r, &fc.mv_class0_fp[i][j][k]);
        for (int j = 0; j < 3; j++) update_mv_prob(r, &fc.mv_fp[i][j]);
      }
      if (hdr.allow_hp) {
        for (int i = 0; i < 2; i++) {
          update_mv_prob(r, &fc.mv_class0_hp[i]);
          update_mv_prob(r, &fc.mv_hp[i]);
        }
      }
    }
    return !r.has_error() && !r.marker_bad;
  }

  // (mode info, tokens, tiles, adaptation, packing continue below)
#include "vp9host_modes.inc"
#include "vp9host_tokens.inc"
#include "vp9host_tiles.inc"
#include "vp9host_adapt.inc"
#include "vp9host_pack.inc"
};

}  // namespace

// ------------------------------------------------------------ C API

extern "C" {

void* vp9h_create() { return new Decoder(); }
void vp9h_destroy(void* h) { delete (Decoder*)h; }

// DecCfg.threads: tile-parallel entropy parse (vpx_codec_dec_cfg_t.threads
// -> decode_tiles_mt parity).  Safe to call between frames.
void vp9h_set_threads(void* h, int n) {
  ((Decoder*)h)->n_threads = n < 1 ? 1 : n;
}

int vp9h_parse(void* h, const uint8_t* data, int64_t size, PlanOut* out) {
  Decoder* d = (Decoder*)h;
  return d->parse_frame(data, size, out);
}

// Pack the most recently parsed frame into the fused-step flat buffer.
// Returns 0 on success, a PackErr code on (tight-tier) overflow.
int64_t vp9h_pack(void* h, const Decoder::PackIn* in, int16_t* out) {
  Decoder* d = (Decoder*)h;
  return d->pack_frame_native(*in, out);
}

// Page compaction of a packed flat in one pass (PAGE = 512 int16, 1 KB).
// Writes the page map g[n_pages] int32 to `map` (0: an all-zero page; i:
// the i-th nonzero page, counted from 1) and the nonzero pages, in order,
// to `pages`, with no zero page and no padding.  Returns the number of
// nonzero pages, or -1 as soon as more than max_pages are nonzero (the
// caller then ships the flat dense; `map` and `pages` hold partial data).
// The device rebuilds the flat from it with one gather of 1 KB rows
// (cuda_vp9_torch/csrc/pages.cu).
int64_t vp9h_compact_pages(const int16_t* flat, int64_t n_pages,
                           int64_t max_pages, int32_t* map, int16_t* pages) {
  const int64_t PAGE = 512;
  int64_t nz = 0;
  for (int64_t p = 0; p < n_pages; p++) {
    const uint64_t* w = (const uint64_t*)(flat + p * PAGE);
    bool any = false;
    for (int64_t i = 0; i < PAGE / 4; i++)
      if (w[i]) { any = true; break; }
    if (!any) { map[p] = 0; continue; }
    if (nz == max_pages) return -1;
    memcpy(pages + nz * PAGE, flat + p * PAGE, PAGE * sizeof(int16_t));
    map[p] = (int32_t)++nz;
  }
  return nz;
}

}

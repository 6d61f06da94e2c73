// The composed kernel's body after a thread's place (x, y, z, tid):
// included into composed.cuh's composed_body (a kernel of its own launch,
// its place from its indices) and composed_body_at (a block of the split
// kernel, divergent_split.cuh, its place given), no include guard, so that
// the composed kernel's instances compile from the text they compiled from
// before the split kernel ran this body too. It reads what the including
// function defines: its parameters, N, NX, NY, in_rows, out_rows, x, y, z
// and tid.

  // every thread stages; one outside the output skips its reads, chains
  // and store
  const bool live = x < dst_w && y < dst_h;
  const int n = live ? min(P, dst_w - x) : 0;  // pixels inside
  const float* fblk = reinterpret_cast<const float*>(blk);
  // the plane's values (the head's offsets of plane 0's stage values, warp
  // coefficients and border and fused chain scalars, read zoff words on:
  // an offset, not a second pointer, keeps the 4-tap shared instance at 63
  // registers, not 66) and its source address
  const int zoff = z * h.plane_stride;
  // a plane past used_planes (the whole block's) reads nothing: each pixel
  // starts with the default's offset as its fill, as an outer CONSTANT
  // border's value (the walk keeps a fill once set), so that the read
  // holds no test of it (on an H100 such a test cost a crop batch's
  // 4-pixel instance 10 %)
  const int held_fill =
      h.used_off >= 0 && z >= __ldg(blk + h.used_off) ? h.default_off - zoff : -1;
  const void* s = src;
  if (h.batch) {
    s = reinterpret_cast<const void*>(__ldg(reinterpret_cast<const unsigned long long*>(blk) + z));
  }

  // the op tables staged first (a table of at most kStageRows rows, all of
  // them at once), so their loads overlap the walks and the taps' loads
  const bool in_once = h.in_n_ops <= kStageRows, out_once = h.out_n_ops <= kStageRows;
  if (in_once) {
    stage_rows(in_rows, consts + h.in_ops_off, h.in_n_ops, 0, h.in_n_ops,
               fblk + zoff + h.in_fp_off, tid, kThreads);
  }
  if (out_once) {
    stage_rows(out_rows, consts + h.out_ops_off, h.out_n_ops, 0, h.out_n_ops,
               fblk + h.out_fp_off, tid, kThreads);
  }

  // the outer walk: the thread's pixels into the core's output
  int xc[P], fo[P];
  int yc = y;
#pragma unroll
  for (int q = 0; q < P; ++q) xc[q] = x + q, fo[q] = held_fill;
  if (live) walk_stages(h.outer, blk + zoff, xc, fo, yc);
  bool sample[P];
  bool any = false;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    sample[q] = q < n && fo[q] < 0;
    any = any || sample[q];
  }

  // the taps' positions on each axis and the taps each pixel's result uses
  // (need: bit k for tap k, v00, v01, v10, v11)
  int xs[NX], ys[NY];
  unsigned need[P];
  float wx[P], wy[P];
  const bool warp = T == 4 && h.core == CM_WARP;
#pragma unroll
  for (int q = 0; q < P; ++q) need[q] = 0u, wx[q] = wy[q] = 0.f;
#pragma unroll
  for (int i = 0; i < NX; ++i) xs[i] = 0;
#pragma unroll
  for (int i = 0; i < NY; ++i) ys[i] = 0;
  // tap i's fill, 4 bits at bit 4i (kNone: none), a thread's taps in one
  // register
  static_assert(N <= 8, "4 bits a tap");
  unsigned none = 0u;
#pragma unroll
  for (int i = 0; i < N; ++i) none |= (unsigned)kNone << (4 * i);
  unsigned fills = none;
  TapRegs<Src, N> regs;
  // a thread none of whose pixels samples the core (all under an outer
  // CONSTANT border's fill) reads no tap
  if (any) {
    if constexpr (T == 1) {
#pragma unroll
      for (int q = 0; q < P; ++q) {
        xs[q] = xc[q];
        need[q] = sample[q] ? 1u : 0u;
      }
      ys[0] = yc;
    } else if (!warp) {
      // the resize: host tables; under the edge rule a weight of 0 keeps the
      // first tap alone, so the second is not read (frame_resize.cuh's
      // bilerp skips it too)
      const int* tp = consts + h.taps_off;
      const float* tw = reinterpret_cast<const float*>(tp + 2 * (h.core_w + h.core_h));
      const bool keep = h.keep_edge != 0;
      ys[0] = __ldg(tp + 2 * h.core_w + yc);
      ys[1] = __ldg(tp + 2 * h.core_w + h.core_h + yc);
      const float row_w = __ldg(tw + h.core_w + yc);
      const bool uy = !(keep && row_w == 0.f);
#pragma unroll
      for (int q = 0; q < P; ++q) {
        if (!sample[q]) continue;
        xs[2 * q] = __ldg(tp + xc[q]);
        xs[2 * q + 1] = __ldg(tp + h.core_w + xc[q]);
        wx[q] = __ldg(tw + xc[q]);
        wy[q] = row_w;
        const bool ux = !(keep && wx[q] == 0.f);
        need[q] = 1u | (ux ? 2u : 0u) | (uy ? 4u : 0u) | (ux && uy ? 8u : 0u);
      }
    } else {
      // the warp: warp.cuh's coordinates and taps over the inner image, the
      // row's terms once for the thread
      float sx[P], sy[P];
      map_coords(fblk + zoff + h.coef_off, h.persp != 0, xc, yc, sx, sy);
      const float fw = (float)h.in_w, fh = (float)h.in_h;  // exact: sides < 2^24
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const float sxq = sx[q], syq = sy[q];
        const float x0f = floorf(sxq), y0f = floorf(syq);
        wx[q] = __fsub_rn(sxq, x0f);
        wy[q] = __fsub_rn(syq, y0f);
        const bool vx0 = x0f >= 0.f && x0f < fw, vx1 = x0f >= -1.f && x0f < fw - 1.f;
        const bool vy0 = y0f >= 0.f && y0f < fh, vy1 = y0f >= -1.f && y0f < fh - 1.f;
        xs[2 * q] = vx0 ? (int)x0f : 0;
        xs[2 * q + 1] = vx1 ? (int)x0f + 1 : 0;
        ys[2 * q] = vy0 ? (int)y0f : 0;
        ys[2 * q + 1] = vy1 ? (int)y0f + 1 : 0;
        need[q] = sample[q] ? ((unsigned)(vy0 && vx0) | (unsigned)(vy0 && vx1) << 1 |
                               (unsigned)(vy1 && vx0) << 2 | (unsigned)(vy1 && vx1) << 3)
                            : 0u;
      }
    }

    // both axes through the upper and the lower stages, once each
    int fx[NX], fy[NY];
    walk_taps(h, blk + zoff, xs, fx, ys, fy);

    // tap k of pixel q: its base position, its fill (the outer of its
    // column's and its row's) and whether it is read
    int ty[N], tx[N];
    unsigned rd = 0u;
#pragma unroll
    for (int q = 0; q < P; ++q) {
#pragma unroll
      for (int k = 0; k < T; ++k) {
        const int i = q * T + k;
        // a resample's v00, v01, v10, v11: column k & 1, row k >> 1
        const int ix = T == 1 ? q : (k & 1), iy = T == 1 ? 0 : (k >> 1);
        const int f = min(fx[ix], fy[iy]);
        tx[i] = xs[ix];
        ty[i] = ys[iy];
        fills ^= (unsigned)(f ^ kNone) << (4 * i);
        if ((need[q] >> k & 1u) && f == kNone) rd |= 1u << i;
      }
    }

    // every load of the thread in one run; the barrier then also finds the
    // tables staged at the start
    load_taps<T == 4>(h, s, ty, tx, rd, regs);
  }
  __syncthreads();

  // each pixel's taps: their values, the fused read's chain, the sample;
  // the fills' tests only where a tap of the thread has one
  const bool filled = fills != none;
  float border[kMaxCh];
#pragma unroll
  for (int c = 0; c < kMaxCh; ++c) {
    border[c] = warp && c < h.tap_ch ? __ldg(fblk + zoff + h.border_off + c) : 0.f;
  }
  float v[P][kMaxCh];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    // each tap the result takes: its lanes, a lower border's value cast to
    // the source's type, a leading YUV -> RGB, the fused read's chain, an
    // upper border's value cast to the chain's type after it; a tap it
    // drops (a resize's of weight 0, a warp's outside its source) costs no
    // work and holds 0 (the warp's border below)
    float t[T][1][kMaxCh];
#pragma unroll
    for (int k = 0; k < T; ++k) {
#pragma unroll
      for (int c = 0; c < kMaxCh; ++c) t[k][0][c] = 0.f;
    }
    if (sample[q]) {
#pragma unroll
      for (int k = 0; k < T; ++k) {
        const int i = q * T + k;
        const int f = (int)(fills >> (4 * i)) & 15;
        if (!(need[q] >> k & 1u)) continue;
#pragma unroll
        for (int c = 0; c < kMaxCh; ++c) t[k][0][c] = regs.lane(i, c);
        if (filled && f >= kMaxStages && f < kNone) {
          const int off = fill_offset(h, f);
#pragma unroll
          for (int c = 0; c < kMaxCh; ++c) {
            if (c < h.lower.nch) {
              t[k][0][c] = cast_to_type(__ldg(fblk + zoff + off + c), h.lower.src_type);
            }
          }
        }
        if (h.lower.conv_first) yuv_to_rgb(t[k][0][0], t[k][0][1], t[k][0][2], conv, t[k][0]);
      }
    }
    if (sample[q] || !in_once) {  // a table staged in chunks: every thread at its barriers
#pragma unroll
      for (int k = 0; k < T; ++k) {
        run_table(t[k], in_rows, in_once, consts + h.in_ops_off, h.in_n_ops,
                  fblk + zoff + h.in_fp_off, tid, need[q] >> k & 1u);
      }
    }
    if (sample[q] && filled) {
#pragma unroll
      for (int k = 0; k < T; ++k) {
        const int i = q * T + k;
        const int f = (int)(fills >> (4 * i)) & 15;
        if (!(need[q] >> k & 1u) || f >= kMaxStages) continue;
        const int off = fill_offset(h, f);
#pragma unroll
        for (int c = 0; c < kMaxCh; ++c) {
          if (c < h.tap_ch) t[k][0][c] = cast_to_type(__ldg(fblk + zoff + off + c), h.tap_type);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kMaxCh; ++c) v[q][c] = 0.f;
    if (sample[q]) {
      if constexpr (T == 1) {
#pragma unroll
        for (int c = 0; c < kMaxCh; ++c) v[q][c] = t[0][0][c];
      } else {
        // a resample reads float32 values: int32's bits converted
        if (h.tap_type == PW_I32) {
#pragma unroll
          for (int k = 0; k < T; ++k) {
#pragma unroll
            for (int c = 0; c < kMaxCh; ++c) {
              t[k][0][c] = __int2float_rn(__float_as_int(t[k][0][c]));
            }
          }
        }
        if (!warp) {
          const bool keep = h.keep_edge != 0;
#pragma unroll
          for (int c = 0; c < kMaxCh; ++c) {
            v[q][c] = bilerp_values(t[0][0][c], t[1][0][c], t[2][0][c], t[3][0][c], wx[q], wy[q],
                                     keep);
          }
        } else {
          // a tap outside the warp's source reads its border
#pragma unroll
          for (int k = 0; k < T; ++k) {
            if (need[q] >> k & 1u) continue;
#pragma unroll
            for (int c = 0; c < kMaxCh; ++c) {
              if (c < h.tap_ch) t[k][0][c] = border[c];
            }
          }
#pragma unroll
          for (int c = 0; c < kMaxCh; ++c) {
            v[q][c] = lerp_rn(lerp_rn(t[0][0][c], t[1][0][c], wx[q]),
                              lerp_rn(t[2][0][c], t[3][0][c], wx[q]), wy[q]);
          }
        }
      }
    } else if (q < n) {
      // an outer CONSTANT border's value, or a held plane's default, cast to
      // the core's type
#pragma unroll
      for (int c = 0; c < kMaxCh; ++c) {
        if (c < h.tap_ch) v[q][c] = cast_to_type(__ldg(fblk + zoff + fo[q] + c), h.core_type);
      }
    }
  }

  // the pipeline's chain
  run_table(v, out_rows, out_once, consts + h.out_ops_off, h.out_n_ops, fblk + h.out_fp_off, tid,
            live);
  if (!live) return;

  // a value stored into a buffer of another dtype: the row that casts it as
  // utils/dtypes.py::astype does, where that takes one
  if (store_op) run_integer_row(store_op, v);
  store_typed(out, out_type, (long long)z * sn + (long long)y * sy + (long long)x * sx, v, n,
              out_ch, sc, sx);

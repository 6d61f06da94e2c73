// The nested kernels' body after a thread's place (x, y, z, tid): included
// into composed_nested.cuh's nested_body (a kernel of its own launch) and
// nested_body_at (a block of the split kernel, divergent_split.cuh), no
// include guard, so that the nested instances compile from the text they
// compiled from before the split kernel ran this body too. It reads what
// the including function defines: its parameters, in_rows, mid_rows,
// out_rows, h, x, y, z, tid, and the block's tile as CVGS_TILE_X0 and
// CVGS_TILE_Y0 (its first column and row) and CVGS_TILE_W and CVGS_TILE_H
// (its width and height), macros whose text is the own launch's indices'
// or the split block's place.

  const bool live = x < dst_w && y < dst_h;
  const float* fblk = reinterpret_cast<const float*>(blk);
  const int zoff = z * h.plane_stride;
  const int* zblk = blk + zoff;
  // a plane past used_planes reads nothing: its pixels start with the
  // default's offset as their fill, as the one-level kernel's do
  const int held_fill =
      h.used_off >= 0 && z >= __ldg(blk + h.used_off) ? h.default_off - zoff : -1;
  const void* s = src;
  if (h.batch) {
    s = reinterpret_cast<const void*>(__ldg(reinterpret_cast<const unsigned long long*>(blk) + z));
  }

  // the op tables staged first where each fits in one chunk
  const bool in_once = h.in_n_ops <= kStageRows, mid_once = n.mid_n_ops <= kStageRows,
             out_once = h.out_n_ops <= kStageRows;
  if (in_once) {
    stage_rows(in_rows, consts + h.in_ops_off, h.in_n_ops, 0, h.in_n_ops,
               fblk + zoff + h.in_fp_off, tid, kThreads);
  }
  if (mid_once) {
    stage_rows(mid_rows, consts + n.mid_ops_off, n.mid_n_ops, 0, n.mid_n_ops,
               fblk + zoff + n.mid_fp_off, tid, kThreads);
  }
  if (out_once) {
    stage_rows(out_rows, consts + h.out_ops_off, h.out_n_ops, 0, h.out_n_ops,
               fblk + h.out_fp_off, tid, kThreads);
  }

  // the outer walk: the pixel into the second level's output
  int xc[1] = {x}, fo[1] = {held_fill};
  int yc = y;
  if (live) walk_stages(h.outer, zblk, xc, fo, yc);
  const bool sample = live && fo[0] < 0;

  float v[1][kMaxCh];
#pragma unroll
  for (int c = 0; c < kMaxCh; ++c) v[0][c] = 0.f;
  if constexpr (kR2) {
    __shared__ Stage2 sg;
    const float* zfblk = fblk + zoff;
    Taps tp;
    resample_taps(n.core2, consts + n.taps2_off, n.core2_w, n.core2_h, n.keep_edge2 != 0,
                  zfblk + n.coef2_off, n.persp2 != 0, n.mid_w, n.mid_h, yc, xc[0], sample, tp);
    // a chain's table staged in chunks holds barriers that every thread
    // reaches, so then every thread runs every round (block-uniform)
    const bool every_tap = !(in_once && mid_once);
    // the staged form in the staging instance where the footprint fits; a
    // held plane's block (block-uniform) takes neither form. The footprint
    // is built beside the tables' staging: a resize's lists by warps 0 (x)
    // and 1 (y) before the first barrier; a warp's box from each warp's
    // extremes, listed after it. A mixed batch's plane whose stage2 is 0
    // (a resize whose taps no two pixels share) goes per tap, as a block
    // past the budget does
    const bool stage = kStage && held_fill < 0 && (!kMixed || n.stage2 != 0);
    const int warp = tid >> 5, lane = tid & 31;
    if (stage) {
      if (n.core2 == CM_RESIZE) {
        if (warp == 0) {
          resize_axis<true>(sg, n, zblk, consts, lane, CVGS_TILE_X0, CVGS_TILE_W, dst_w);
        } else if (warp == 1) {
          resize_axis<false>(sg, n, zblk, consts, lane, CVGS_TILE_Y0, CVGS_TILE_H, dst_h);
        }
      } else {
        int ext[4] = {INT_MAX, INT_MIN, INT_MAX, INT_MIN};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!(tp.need >> k & 1u)) continue;
          ext[0] = min(ext[0], tp.xs[k & 1]);
          ext[1] = max(ext[1], tp.xs[k & 1]);
          ext[2] = min(ext[2], tp.ys[k >> 1]);
          ext[3] = max(ext[3], tp.ys[k >> 1]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ext[e] = e & 1 ? __reduce_max_sync(0xffffffffu, ext[e])
                         : __reduce_min_sync(0xffffffffu, ext[e]);
          if (lane == 0) sg.part[warp][e] = ext[e];
        }
      }
    }
    __syncthreads();  // the op tables, and the lists or each warp's extremes
    if (stage && n.core2 != CM_RESIZE) {
      if (warp == 0) {
        box_axis<true>(sg, n, zblk, consts, lane);
      } else if (warp == 1) {
        box_axis<false>(sg, n, zblk, consts, lane);
      }
      __syncthreads();
    }
    const int nx = stage ? sg.n[0] : -1, ny = stage ? sg.n[1] : -1;
    const bool staged = nx >= 0 && ny >= 0 && nx * ny * n.mid_ch <= kGrid2;
    const int entries = staged ? nx * ny : 0;
    const int rounds = staged ? (entries + kThreads - 1) / kThreads : held_fill < 0 ? 4 : 0;
    // one value of the middle image a round (one value's evaluation live
    // at a time, the loop not unrolled), into the grid: staged, entry r *
    // kThreads + tid at the block's walked lists; per tap, this thread's
    // tap r, walked here, into the thread's own slot (a tap its result
    // does not take costs nothing), so that no tap's value is held in
    // registers across the loop
#pragma unroll 1
    for (int r = 0; r < rounds; ++r) {
      int e = 0, xm[1], ym[1], fxm[1] = {kNone}, fym[1] = {kNone}, i = 0, j = 0;
      bool on;
      if (staged) {
        e = r * kThreads + tid;
        on = e < entries;
        i = on ? e / nx : 0;
        j = on ? e - i * nx : 0;
        xm[0] = sg.pos[0][j];
        ym[0] = sg.pos[1][i];
        fxm[0] = sg.fill[0][j];
        fym[0] = sg.fill[1][i];
      } else {
        on = tp.need >> r & 1u;
        xm[0] = tp.xs[r & 1];
        ym[0] = tp.ys[r >> 1];
        walk_axis<true>(n.above, zblk, 0, xm, fxm);
        walk_axis<false>(n.above, zblk, 0, ym, fym);
        walk_axis<true>(n.below, zblk, kMaxStages, xm, fxm);
        walk_axis<false>(n.below, zblk, kMaxStages, ym, fym);
      }
      if (!on && !every_tap) continue;
      const int f = min(fxm[0], fym[0]);
      const bool core_on = on && f == kNone;
      // the core's taps: a resize's from the block's lists where staged,
      // else from the position (walk_taps)
      Taps ct;
      int cfx[2], cfy[2];
      if (staged && h.core == CM_RESIZE) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          ct.xs[k] = sg.tap[0][j][k];
          ct.ys[k] = sg.tap[1][i][k];
          cfx[k] = sg.tfill[0][j][k];
          cfy[k] = sg.tfill[1][i][k];
        }
        ct.wx = sg.w[0][j];
        ct.wy = sg.w[1][i];
        ct.need = core_on ? resize_need(ct.wx, ct.wy, h.keep_edge != 0) : 0u;
      } else {
        resample_taps(h.core, consts + h.taps_off, h.core_w, h.core_h, h.keep_edge != 0,
                      zfblk + h.coef_off, h.persp != 0, h.in_w, h.in_h, ym[0], xm[0], core_on,
                      ct);
        walk_taps(h, zblk, ct.xs, cfx, ct.ys, cfy);
      }
      float u[1][kMaxCh];
      core_sample<Src>(h, conv, s, zblk, consts, in_rows, in_once, tid, ct, cfx, cfy, u[0]);
      mid_finish(n, zblk, consts, mid_rows, mid_once, tid, f, on, u);
      if (on) {
#pragma unroll
        for (int c = 0; c < kMaxCh; ++c) {
          if (c < n.mid_ch) sg.grid[staged ? c * entries + e : slot(r, c, tid)] = u[0][c];
        }
      }
    }
    if (staged) __syncthreads();
    // each tap the result takes: staged, from the grid through the axes'
    // maps; per tap, from the thread's slot; a tap it does not take holds 0
    float t[4][1][kMaxCh];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = staged && sample && (tp.need >> k & 1u)
                        ? sg.map[1][tp.ys[k >> 1] - sg.lo[1]] * nx +
                              sg.map[0][tp.xs[k & 1] - sg.lo[0]]
                        : 0;
#pragma unroll
      for (int c = 0; c < kMaxCh; ++c) {
        t[k][0][c] = 0.f;
        if (sample && (tp.need >> k & 1u) && c < n.mid_ch) {
          t[k][0][c] = sg.grid[staged ? c * entries + e : slot(k, c, tid)];
        }
      }
    }
    if (sample) {
      sample_taps(n.core2, n.keep_edge2 != 0, n.mid_type, tp, t, zfblk + n.border2_off, n.mid_ch,
                  v[0]);
    }
  } else {
    __syncthreads();  // the op tables
    float u[1][kMaxCh];
    mid_value<Src>(n, conv, s, zblk, consts, in_rows, mid_rows, in_once, mid_once, tid, yc, xc[0],
                   sample, u);
    if (sample) {
#pragma unroll
      for (int c = 0; c < kMaxCh; ++c) v[0][c] = u[0][c];
    }
  }
  if (live && !sample) {
    // an outer CONSTANT border's value, or a held plane's default, cast to
    // the read value's type
#pragma unroll
    for (int c = 0; c < kMaxCh; ++c) {
      if (c < n.mid_ch) v[0][c] = cast_to_type(__ldg(fblk + zoff + fo[0] + c), h.core_type);
    }
  }

  // the pipeline's chain
  run_table(v, out_rows, out_once, consts + h.out_ops_off, h.out_n_ops, fblk + h.out_fp_off, tid,
            live);
  if (!live) return;
  if (store_op) run_integer_row(store_op, v);
  store_typed(out, out_type, (long long)z * sn + (long long)y * sy + (long long)x * sx, v, 1,
              out_ch, sc, sx);

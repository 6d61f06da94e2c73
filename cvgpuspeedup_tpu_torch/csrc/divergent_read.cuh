// K6's read of a thread's P pixels: the body of divergent_kernel.cuh's
// divergent_body and divergent_values, included into each (no include
// guard), so that K6's own instances compile from the text they compiled
// from before the split kernel read K6's groups too. It reads what the
// including body defines: x, y, z, n (the pixels inside the row), the
// plane's `base` and group descriptor `d`, src_h, src_w, nch, fblk and
// fconsts (blk and consts as floats), blk, consts, dst_w, dst_h; it fills
// v[P][kMaxCh] with the values before the group's chain and defines ch, the
// channels the chain runs on.

#pragma unroll
  for (int q = 0; q < P; ++q) {
#pragma unroll
    for (int c = 0; c < kMaxCh; ++c) v[q][c] = 0.f;
  }
  int ch = d.kind == K_NV12 ? ((d.flags >> 3) & 1 ? 4 : 3) : nch;
  // a ragged BatchRead group (images, NV12 reads or warps): its planes from
  // used_planes on hold its default, which then runs through the chain
  const bool held =
      d.kind != K_CROP && d.kind != K_STACK && d.used >= 0 && z >= __ldg(blk + d.used);
  if (held) {
#pragma unroll
    for (int q = 0; q < P; ++q) {
#pragma unroll
      for (int c = 0; c < kMaxCh; ++c) v[q][c] = c < ch ? __ldg(fblk + d.first + c) : 0.f;
    }
  }
  switch (held ? -1 : d.kind) {
    case K_IMAGE:
    case K_CIRC: {
      int pz = d.n_src == 1 ? 0 : z;  // a stack's plane z, or the plane's own image
      if (d.kind == K_CIRC) {
        const int first = __ldg(blk + d.first);
        const int t = d.asc ? first + z : first - z;
        pz = t - floor_div(t, d.n_src) * d.n_src;  // floor modulo, as Python's %
      }
      const long long off = (((long long)pz * src_h + y) * src_w + x) * nch;
      if constexpr (kAny) {
        with_source<false>(d.src, base, [&](auto src) {
#pragma unroll
          for (int q = 0; q < P; ++q) {
            if (q < n) load_pixel(src + off + q * nch, nch, v[q]);
          }
        });
      } else {
#pragma unroll
        for (int q = 0; q < P; ++q) {
          if (q >= n) continue;
          if (d.src == S_U8) {
            load_pixel(static_cast<const uint8_t*>(base) + off + q * nch, nch, v[q]);
          } else if (d.src == S_F64) {
            load_pixel(static_cast<const double*>(base) + off + q * nch, nch, v[q]);
          } else {
            load_pixel(static_cast<const float*>(base) + off + q * nch, nch, v[q]);
          }
        }
      }
      break;
    }
    case K_CROP:
    case K_STACK: {
      const float* bg = fblk + d.aux;
      const bool used = z < __ldg(blk + d.used);
      const int* r = blk + d.data + 4 * z;
      const int rx = __ldg(r), ry = __ldg(r + 1), rw = __ldg(r + 2), rh = __ldg(r + 3);
      const long long plane = d.kind == K_STACK ? (long long)z * src_h * src_w * nch : 0;
      if constexpr (kAny) {
        bool sampled[P];
#pragma unroll
        for (int q = 0; q < P; ++q) sampled[q] = false;
        if (used) {
          with_source<true>(d.src, base, [&](auto src) {
#pragma unroll
            for (int q = 0; q < P; ++q) {
              if (q < n) {
                sampled[q] = sample_crop(src + plane, src_h, src_w, nch, rx, ry, rw, rh, dst_w,
                                         dst_h, d.mode, x + q, y, v[q]);
              }
            }
          });
        }
#pragma unroll
        for (int q = 0; q < P; ++q) {
          if (q < n && !sampled[q]) {
#pragma unroll
            for (int c = 0; c < kMaxCh; ++c) v[q][c] = c < nch ? __ldg(bg + c) : 0.f;
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < P; ++q) {
          if (q >= n) continue;
          bool sampled = false;
          if (used) {
            if (d.src == S_U8) {
              sampled = sample_crop(static_cast<const uint8_t*>(base) + plane, src_h, src_w, nch,
                                    rx, ry, rw, rh, dst_w, dst_h, d.mode, x + q, y, v[q]);
            } else if (d.src == S_F64) {
              sampled = sample_crop(static_cast<const double*>(base) + plane, src_h, src_w, nch,
                                    rx, ry, rw, rh, dst_w, dst_h, d.mode, x + q, y, v[q]);
            } else {
              sampled = sample_crop(static_cast<const float*>(base) + plane, src_h, src_w, nch,
                                    rx, ry, rw, rh, dst_w, dst_h, d.mode, x + q, y, v[q]);
            }
          }
          if (!sampled) {
#pragma unroll
            for (int c = 0; c < kMaxCh; ++c) v[q][c] = c < nch ? __ldg(bg + c) : 0.f;
          }
        }
      }
      break;
    }
    case K_NV12: {
      const float* wts = fconsts + d.aux;
      const float* cf = wts + dst_w + dst_h;
      const Conv conv{(d.flags >> 2) & 1, (d.flags >> 3) & 1, __ldg(cf),     __ldg(cf + 1),
                      __ldg(cf + 2),      __ldg(cf + 3),      __ldg(cf + 4), __ldg(cf + 5)};
      const int* taps = consts + d.data;
      nv12_pixels<P>(nv12_rows(static_cast<const uint8_t*>(base), src_h, src_w, taps, wts, dst_w,
                               dst_h, y),
                     (d.flags >> 1) & 1, taps, wts, dst_w, dst_h, x, n, (d.flags & 1) != 0, conv, v);
      break;
    }
    case K_WARP: {
      const float* c = fblk + d.data + kCoeffs * z;
      const float* b = fblk + d.aux + kMaxCh * z;
      const bool persp = (d.flags & 1) != 0;
      if constexpr (kAny) {
        with_source<true>(d.src, base, [&](auto src) {
          using SrcT = std::remove_cv_t<std::remove_pointer_t<decltype(src)>>;
#pragma unroll
          for (int q = 0; q < P; ++q) {
            if (q >= n) continue;
            if (persp) {
              sample_warp<SrcT, true>(src, src_h, src_w, nch, c, b, x + q, y, v[q]);
            } else {
              sample_warp<SrcT, false>(src, src_h, src_w, nch, c, b, x + q, y, v[q]);
            }
          }
        });
      } else {
#pragma unroll
        for (int q = 0; q < P; ++q) {
          if (q >= n) continue;
          if (d.src == S_U8) {
            const uint8_t* src = static_cast<const uint8_t*>(base);
            if (persp) {
              sample_warp<uint8_t, true>(src, src_h, src_w, nch, c, b, x + q, y, v[q]);
            } else {
              sample_warp<uint8_t, false>(src, src_h, src_w, nch, c, b, x + q, y, v[q]);
            }
          } else if (d.src == S_F64) {
            const double* src = static_cast<const double*>(base);
            if (persp) {
              sample_warp<double, true>(src, src_h, src_w, nch, c, b, x + q, y, v[q]);
            } else {
              sample_warp<double, false>(src, src_h, src_w, nch, c, b, x + q, y, v[q]);
            }
          } else {
            const float* src = static_cast<const float*>(base);
            if (persp) {
              sample_warp<float, true>(src, src_h, src_w, nch, c, b, x + q, y, v[q]);
            } else {
              sample_warp<float, false>(src, src_h, src_w, nch, c, b, x + q, y, v[q]);
            }
          }
        }
      }
      break;
    }
    default:
      break;
  }

// pychain_tpu_torch native host runtime: FST I/O, graph compilation,
// leaky priors, Kaldi feature decoding, and a CPU forward-backward
// reference engine.
//
// The port's copy of the JAX package's native runtime
// (pychain_tpu/csrc/pychain_native.cc), unchanged below this header: a
// dependency-free C++17 shared library exposing a flat extern "C" ABI,
// bound from Python by ctypes (pychain_tpu_torch/csrc/native.py), which
// builds it with g++ at first use.  It parses the OpenFST binary format
// directly, lowers FSTs to the same flat transition tensors as
// pychain_tpu_torch.graphs.compiler, decodes Kaldi feature matrices, and
// implements the chain forward-backward recurrences
// (chain-computation.h:109-155 "version 3" equations and the log-domain
// variant) as a host-side oracle with masked unequal-length handling.
//
// This file is an original implementation; it shares only the on-disk
// format and the published recurrence equations with the reference.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <string>
#include <vector>

namespace {

constexpr int32_t kFstMagic = 2125659606;
constexpr float kNegInf = -std::numeric_limits<float>::infinity();

struct Fst {
  int32_t start = -1;
  std::vector<float> final_w;        // tropical final weights, +inf = none
  std::vector<int64_t> offsets;      // CSR (S+1)
  std::vector<int32_t> ilabels, olabels, nextstates;
  std::vector<float> weights;
  int num_states() const { return (int)final_w.size(); }
  int num_arcs() const { return (int)ilabels.size(); }
};

template <typename T>
bool read_pod(FILE* f, T* out) { return fread(out, sizeof(T), 1, f) == 1; }

// Bytes between the current position and EOF (-1 on error).  Used to
// bound header-declared element counts BEFORE allocating: a corrupted
// count must fail cleanly, not bad_alloc/OOB (fuzz hardening; the
// Python readers apply the same bounds so accept/reject decisions
// agree).
long remaining_bytes(FILE* f) {
  long pos = ftell(f);
  if (pos < 0 || fseek(f, 0, SEEK_END) != 0) return -1;
  long end = ftell(f);
  if (fseek(f, pos, SEEK_SET) != 0) return -1;
  return end - pos;
}

bool read_string(FILE* f, std::string* out) {
  int32_t n;
  if (!read_pod(f, &n) || n < 0 || n > 1 << 20) return false;
  out->resize(n);
  return n == 0 || fread(&(*out)[0], 1, n, f) == (size_t)n;
}

// Skip one serialized OpenFST SymbolTable (symbol-table.cc).
bool skip_symbol_table(FILE* f) {
  int32_t magic;
  std::string s;
  int64_t avail, size, key;
  if (!read_pod(f, &magic) || magic != 2125658996) return false;
  if (!read_string(f, &s) || !read_pod(f, &avail) || !read_pod(f, &size))
    return false;
  for (int64_t i = 0; i < size; i++)
    if (!read_string(f, &s) || !read_pod(f, &key)) return false;
  return true;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------
// FST I/O
// ---------------------------------------------------------------------

// Read an OpenFST binary VectorFst<StdArc>; offset >= 0 seeks first
// (Kaldi ark random access).  Returns opaque handle or nullptr.
void* pc_fst_read(const char* path, long offset) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  if (offset >= 0 && fseek(f, offset, SEEK_SET) != 0) { fclose(f); return nullptr; }

  auto fail = [&]() -> void* { fclose(f); return nullptr; };
  int32_t magic, version, flags;
  std::string fsttype, arctype;
  uint64_t properties;
  int64_t start, num_states, num_arcs;
  if (!read_pod(f, &magic) || magic != kFstMagic) return fail();
  if (!read_string(f, &fsttype) ||
      (fsttype != "vector" && fsttype != "const")) return fail();
  if (!read_string(f, &arctype) || arctype != "standard") return fail();
  if (!read_pod(f, &version)) return fail();
  if (!read_pod(f, &flags)) return fail();
  if (!read_pod(f, &properties)) return fail();
  if (!read_pod(f, &start) || !read_pod(f, &num_states) ||
      !read_pod(f, &num_arcs)) return fail();
  // embedded symbol tables sit between header and states; skip them
  if ((flags & 0x1) && !skip_symbol_table(f)) return fail();
  if ((flags & 0x2) && !skip_symbol_table(f)) return fail();

  // corrupted-count guards: every state/arc record costs file bytes,
  // so counts beyond the remaining payload are rejected BEFORE any
  // allocation (same rule as graphs/fst.py read_stream)
  long rem = remaining_bytes(f);
  if (rem < 0 || num_states < 0 || num_arcs < 0 || start < -1 ||
      num_arcs > rem / 16)
    return fail();
  // range-check the 64-bit start BEFORE the int32 truncation below: a
  // corrupted high word must reject, not alias a valid state id
  if (num_states > 0 && (start < 0 || start >= num_states))
    return fail();

  auto* fst = new Fst();
  fst->start = (int32_t)start;
  struct ArcRec { int32_t il, ol; float w; int32_t ns; };
  auto fail_del = [&]() -> void* { delete fst; fclose(f); return nullptr; };
  // post-load structural validation, mirroring FST.validate():
  // start range, nextstate range, non-negative ilabels
  auto validate = [&]() -> bool {
    const int S = fst->num_states();
    if (S == 0) { fst->start = -1; return true; }
    if (fst->start < 0 || fst->start >= S) return false;
    if (fst->offsets[S] > (int64_t)fst->ilabels.size()) return false;
    for (size_t a = 0; a < fst->nextstates.size(); a++) {
      if (fst->nextstates[a] < 0 || fst->nextstates[a] >= S) return false;
      if (fst->ilabels[a] < 0) return false;
    }
    return true;
  };
  if (fsttype == "const") {
    // ConstFst<StdArc, uint32>: flat state records then flat arcs;
    // version 1 = 16-byte aligned arrays, 2 = unaligned.
    if (version != 1 && version != 2) { delete fst; return fail(); }
    if (num_states > rem / 20) return fail_del();
    auto align16 = [&]() {
      if (version == 1) {
        long pos = ftell(f);
        long pad = (16 - pos % 16) % 16;
        if (pad) fseek(f, pad, SEEK_CUR);
      }
    };
    struct ConstState { float fw; uint32_t pos, narcs, nieps, noeps; };
    if (num_states > 0) {
      fst->final_w.resize(num_states);
      fst->offsets.resize(num_states + 1, 0);
      std::vector<ConstState> states(num_states);
      align16();
      if (fread(states.data(), sizeof(ConstState), num_states, f) !=
          (size_t)num_states) { delete fst; return fail(); }
      for (int64_t s = 0; s < num_states; s++) {
        if ((int64_t)states[s].pos != fst->offsets[s]) {  // must be CSR
          delete fst; return fail();
        }
        fst->final_w[s] = states[s].fw;
        fst->offsets[s + 1] = fst->offsets[s] + states[s].narcs;
      }
      std::vector<ArcRec> arcs(num_arcs);
      align16();
      if (num_arcs && fread(arcs.data(), sizeof(ArcRec), num_arcs, f) !=
          (size_t)num_arcs) { delete fst; return fail(); }
      for (auto& a : arcs) {
        fst->ilabels.push_back(a.il); fst->olabels.push_back(a.ol);
        fst->weights.push_back(a.w); fst->nextstates.push_back(a.ns);
      }
    }
    if (!validate()) return fail_del();
    fclose(f);
    return fst;
  }
  if (version < 2) { delete fst; return fail(); }
  if (num_states > rem / 12) return fail_del();
  if (num_states > 0) {
    fst->final_w.resize(num_states);
    fst->offsets.resize(num_states + 1, 0);
    if (num_arcs > 0) {
      fst->ilabels.reserve(num_arcs); fst->olabels.reserve(num_arcs);
      fst->weights.reserve(num_arcs); fst->nextstates.reserve(num_arcs);
    }
    std::vector<ArcRec> buf;
    for (int64_t s = 0; s < num_states; s++) {
      float fw; int64_t narcs;
      if (!read_pod(f, &fw) || !read_pod(f, &narcs) || narcs < 0 ||
          narcs > rem / 16) {
        delete fst; return fail();
      }
      fst->final_w[s] = fw;
      fst->offsets[s + 1] = fst->offsets[s] + narcs;
      buf.resize(narcs);
      if (narcs && fread(buf.data(), sizeof(ArcRec), narcs, f) != (size_t)narcs) {
        delete fst; return fail();
      }
      for (auto& a : buf) {
        fst->ilabels.push_back(a.il); fst->olabels.push_back(a.ol);
        fst->weights.push_back(a.w); fst->nextstates.push_back(a.ns);
      }
    }
  }
  if (!validate()) return fail_del();
  fclose(f);
  return fst;
}

void pc_fst_free(void* h) { delete (Fst*)h; }
int pc_fst_num_states(void* h) { return ((Fst*)h)->num_states(); }
int pc_fst_num_arcs(void* h) { return ((Fst*)h)->num_arcs(); }
int pc_fst_start(void* h) { return ((Fst*)h)->start; }

// Copy raw fields out (caller allocates): final (S,), offsets (S+1,) i64,
// ilabels/olabels/nextstates (K,) i32, weights (K,) f32.
void pc_fst_fields(void* h, float* final_w, int64_t* offsets,
                   int32_t* ilabels, int32_t* olabels, float* weights,
                   int32_t* nextstates) {
  Fst* fst = (Fst*)h;
  std::memcpy(final_w, fst->final_w.data(), fst->num_states() * 4);
  std::memcpy(offsets, fst->offsets.data(), (fst->num_states() + 1) * 8);
  std::memcpy(ilabels, fst->ilabels.data(), fst->num_arcs() * 4);
  std::memcpy(olabels, fst->olabels.data(), fst->num_arcs() * 4);
  std::memcpy(weights, fst->weights.data(), fst->num_arcs() * 4);
  std::memcpy(nextstates, fst->nextstates.data(), fst->num_arcs() * 4);
}

// Write an OpenFST binary VectorFst<StdArc> from raw fields.
int pc_fst_write(const char* path, int32_t start, int32_t num_states,
                 int64_t num_arcs, const float* final_w,
                 const int64_t* offsets, const int32_t* ilabels,
                 const int32_t* olabels, const float* weights,
                 const int32_t* nextstates) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  auto w_i32 = [&](int32_t v) { fwrite(&v, 4, 1, f); };
  auto w_i64 = [&](int64_t v) { fwrite(&v, 8, 1, f); };
  w_i32(kFstMagic);
  w_i32(6); fwrite("vector", 1, 6, f);
  w_i32(8); fwrite("standard", 1, 8, f);
  w_i32(2);                       // VectorFst file version
  w_i32(0);                       // flags
  uint64_t props = 0; fwrite(&props, 8, 1, f);
  w_i64(start); w_i64(num_states); w_i64(num_arcs);
  for (int32_t s = 0; s < num_states; s++) {
    fwrite(&final_w[s], 4, 1, f);
    int64_t lo = offsets[s], hi = offsets[s + 1];
    w_i64(hi - lo);
    for (int64_t k = lo; k < hi; k++) {
      fwrite(&ilabels[k], 4, 1, f);
      fwrite(&olabels[k], 4, 1, f);
      fwrite(&weights[k], 4, 1, f);
      fwrite(&nextstates[k], 4, 1, f);
    }
  }
  fclose(f);
  return 0;
}

// ---------------------------------------------------------------------
// Graph compilation (fst_to_tensor semantics; see compiler.py)
// ---------------------------------------------------------------------

// Outputs (caller allocates; K = num_arcs, S = num_states):
//   fwd_trans (K,3) i32 [src,dst,pdf] grouped by src;
//   fwd_probs (K,) f32; fwd_idx (S,2) i32;
//   bwd_* grouped by dst; final_probs (S,) f32.
// log_domain=0 exponentiates probs.  Returns 0 ok, -1 on epsilon arc.
int pc_fst_compile(void* h, int log_domain, int32_t* fwd_trans,
                   float* fwd_probs, int32_t* fwd_idx, int32_t* bwd_trans,
                   float* bwd_probs, int32_t* bwd_idx, float* final_probs) {
  Fst* fst = (Fst*)h;
  const int S = fst->num_states();
  const int64_t K = fst->num_arcs();

  // forward: arcs are already stored grouped by source state
  int64_t k = 0;
  for (int s = 0; s < S; s++) {
    fwd_idx[2 * s] = (int32_t)k;
    for (int64_t a = fst->offsets[s]; a < fst->offsets[s + 1]; a++, k++) {
      int32_t pdf = fst->ilabels[a] - 1;
      if (pdf < 0) return -1;
      fwd_trans[3 * k] = s;
      fwd_trans[3 * k + 1] = fst->nextstates[a];
      fwd_trans[3 * k + 2] = pdf;
      fwd_probs[k] = -fst->weights[a];
    }
    fwd_idx[2 * s + 1] = (int32_t)k;
  }

  // backward: counting sort by destination (stable in arc order)
  std::vector<int64_t> count(S + 1, 0);
  for (int64_t a = 0; a < K; a++) count[fst->nextstates[a] + 1]++;
  for (int s = 0; s < S; s++) count[s + 1] += count[s];
  std::vector<int64_t> pos(count.begin(), count.end() - 1);
  for (int s = 0; s < S; s++) {
    bwd_idx[2 * s] = (int32_t)count[s];
    bwd_idx[2 * s + 1] = (int32_t)count[s + 1];
  }
  for (int s = 0; s < S; s++) {
    for (int64_t a = fst->offsets[s]; a < fst->offsets[s + 1]; a++) {
      int64_t p = pos[fst->nextstates[a]]++;
      bwd_trans[3 * p] = s;
      bwd_trans[3 * p + 1] = fst->nextstates[a];
      bwd_trans[3 * p + 2] = fst->ilabels[a] - 1;
      bwd_probs[p] = -fst->weights[a];
    }
  }

  for (int s = 0; s < S; s++) final_probs[s] = -fst->final_w[s];
  if (!log_domain) {
    for (int64_t a = 0; a < K; a++) {
      fwd_probs[a] = std::exp(fwd_probs[a]);
      bwd_probs[a] = std::exp(bwd_probs[a]);
    }
    for (int s = 0; s < S; s++) final_probs[s] = std::exp(final_probs[s]);
  }
  return 0;
}

// Leaky-HMM priors by power iteration (set_leaky_probs semantics):
// per-state mass normalised to 1 (arcs + final), num_iters steps from a
// one-hot start, renormalised, occupancies averaged.
int pc_fst_leaky(void* h, int num_iters, float* out) {
  Fst* fst = (Fst*)h;
  const int S = fst->num_states();
  if (S == 0 || fst->start < 0 || fst->start >= S) return -1;
  std::vector<double> nf(S), cur(S, 0.0), nxt(S, 0.0), avg(S, 0.0);
  for (int s = 0; s < S; s++) {
    double tot = std::exp(-(double)fst->final_w[s]);
    for (int64_t a = fst->offsets[s]; a < fst->offsets[s + 1]; a++)
      tot += std::exp(-(double)fst->weights[a]);
    if (!(tot > 0.0 && tot < 100.0)) return -1;
    nf[s] = 1.0 / tot;
  }
  cur[fst->start] = 1.0;
  for (int it = 0; it < num_iters; it++) {
    for (int s = 0; s < S; s++) avg[s] += cur[s] / num_iters;
    std::fill(nxt.begin(), nxt.end(), 0.0);
    for (int s = 0; s < S; s++) {
      double flow = cur[s] * nf[s];
      for (int64_t a = fst->offsets[s]; a < fst->offsets[s + 1]; a++)
        nxt[fst->nextstates[a]] += flow * std::exp(-(double)fst->weights[a]);
    }
    double tot = 0.0;
    for (int s = 0; s < S; s++) tot += nxt[s];
    for (int s = 0; s < S; s++) cur[s] = nxt[s] / tot;
  }
  for (int s = 0; s < S; s++) out[s] = (float)avg[s];
  return 0;
}

// ---------------------------------------------------------------------
// CPU forward-backward reference engine (masked unequal lengths)
// ---------------------------------------------------------------------
// Probability domain with leaky HMM.  Single shared graph across the
// batch (the denominator case).  Arrays:
//   bwd_trans (K,3)/bwd_probs (K,) grouped by dst; fwd_* grouped by src;
//   init/final/leaky (S,); px (B,T,P) = exp(clamped nnet output);
//   lengths (B,).  Outputs objf (B,), gamma (B,T,P) zero-initialised.
// Returns 0, or 1 if any alpha-sum was non-positive (failure).
int pc_fwdbwd_prob(int B, int T, int P, int S, int64_t K,
                   const int32_t* fwd_trans, const float* fwd_probs,
                   const int32_t* bwd_trans, const float* bwd_probs,
                   const float* init, const float* final_p,
                   const float* leaky, float leaky_coeff, const float* px,
                   const int32_t* lengths, float* objf, float* gamma) {
  int rc = 0;
  std::vector<float> alpha((size_t)(T + 1) * S);       // alpha-dash rows
  std::vector<float> asum(T + 1), bd(S), bnext(S);
  for (int b = 0; b < B; b++) {
    const int Tb = lengths[b];
    const float* pxb = px + (size_t)b * T * P;
    float* gb = gamma + (size_t)b * T * P;
    // forward
    double ll = 0.0;
    {
      double s0 = 0.0;
      for (int i = 0; i < S; i++) s0 += init[i];
      asum[0] = (float)s0;
      for (int i = 0; i < S; i++)
        alpha[i] = init[i] + leaky_coeff * (float)s0 * leaky[i];
      ll += std::log(s0);
    }
    for (int t = 1; t <= Tb; t++) {
      const float* xrow = pxb + (size_t)(t - 1) * P;
      const float inv = 1.0f / asum[t - 1];
      float* at = alpha.data() + (size_t)t * S;
      const float* ap = alpha.data() + (size_t)(t - 1) * S;
      double s = 0.0;
      for (int i = 0; i < S; i++) at[i] = 0.0f;
      for (int64_t a = 0; a < K; a++) {
        const int32_t* tr = bwd_trans + 3 * a;
        at[tr[1]] += ap[tr[0]] * bwd_probs[a] * xrow[tr[2]];
      }
      for (int i = 0; i < S; i++) { at[i] *= inv; s += at[i]; }
      if (!(s > 0.0) || s != s) { rc = 1; s = 1.0; }
      asum[t] = (float)s;
      for (int i = 0; i < S; i++)
        at[i] += leaky_coeff * (float)s * leaky[i];
      if (t < Tb) ll += std::log(s);
    }
    double tot = 0.0;
    {
      const float* aT = alpha.data() + (size_t)Tb * S;
      for (int i = 0; i < S; i++) tot += (double)aT[i] * final_p[i];
    }
    objf[b] = (float)(ll + std::log(tot));
    // backward
    const float inv_tot = (float)(1.0 / tot);
    for (int i = 0; i < S; i++) bd[i] = final_p[i] * inv_tot;
    for (int t = Tb - 1; t >= 0; t--) {
      // leaky correction: beta(t+1) from beta-dash(t+1)
      double lsum = 0.0;
      for (int i = 0; i < S; i++) lsum += (double)bd[i] * leaky[i];
      for (int i = 0; i < S; i++)
        bnext[i] = bd[i] + leaky_coeff * (float)lsum;
      const float* xrow = pxb + (size_t)t * P;
      const float* at = alpha.data() + (size_t)t * S;
      const float inv = 1.0f / asum[t];
      float* grow = gb + (size_t)t * P;
      for (int i = 0; i < S; i++) bd[i] = 0.0f;
      for (int64_t a = 0; a < K; a++) {
        const int32_t* tr = fwd_trans + 3 * a;
        const float vf = fwd_probs[a] * bnext[tr[1]] * xrow[tr[2]];
        bd[tr[0]] += vf;
        grow[tr[2]] += vf * at[tr[0]] * inv;
      }
      for (int i = 0; i < S; i++) bd[i] *= inv;
    }
  }
  return rc;
}

// Log domain, no leaky HMM, per-sequence graphs.  Graph arrays carry a
// leading batch dim: bwd_trans (B,K,3) etc; init/final (B,S);
// x (B,T,P) log-likelihoods.  gamma returned in linear space.
int pc_fwdbwd_log(int B, int T, int P, int S, int64_t K,
                  const int32_t* fwd_trans, const float* fwd_probs,
                  const int32_t* bwd_trans, const float* bwd_probs,
                  const float* init, const float* final_p, const float* x,
                  const int32_t* lengths, float* objf, float* gamma) {
  auto logadd = [](double a, double b) {
    if (a == -std::numeric_limits<double>::infinity()) return b;
    if (b == -std::numeric_limits<double>::infinity()) return a;
    double m = std::max(a, b);
    return m + std::log1p(std::exp(std::min(a, b) - m));
  };
  const double ninf = -std::numeric_limits<double>::infinity();
  std::vector<double> alpha((size_t)(T + 1) * S);
  std::vector<double> asum(T + 1), bd(S), bnext(S);
  for (int b = 0; b < B; b++) {
    const int Tb = lengths[b];
    const float* xb = x + (size_t)b * T * P;
    float* gb = gamma + (size_t)b * T * P;
    const int32_t* bt = bwd_trans + (size_t)b * K * 3;
    const float* bp = bwd_probs + (size_t)b * K;
    const int32_t* ft = fwd_trans + (size_t)b * K * 3;
    const float* fp = fwd_probs + (size_t)b * K;
    const float* in = init + (size_t)b * S;
    const float* fi = final_p + (size_t)b * S;

    for (int i = 0; i < S; i++) alpha[i] = in[i];
    asum[0] = 0.0;  // by definition (cc:89)
    double ll = 0.0;
    for (int t = 1; t <= Tb; t++) {
      const float* xrow = xb + (size_t)(t - 1) * P;
      double* at = alpha.data() + (size_t)t * S;
      const double* ap = alpha.data() + (size_t)(t - 1) * S;
      for (int i = 0; i < S; i++) at[i] = ninf;
      for (int64_t a = 0; a < K; a++) {
        const int32_t* tr = bt + 3 * a;
        if (bp[a] == kNegInf) continue;  // padding arc
        at[tr[1]] = logadd(at[tr[1]],
                           ap[tr[0]] + (double)bp[a] + (double)xrow[tr[2]]);
      }
      double s = ninf;
      for (int i = 0; i < S; i++) { at[i] -= asum[t - 1]; s = logadd(s, at[i]); }
      asum[t] = s;
      if (t < Tb) ll += s;
    }
    double tlp = ninf;
    {
      const double* aT = alpha.data() + (size_t)Tb * S;
      for (int i = 0; i < S; i++) tlp = logadd(tlp, aT[i] + (double)fi[i]);
    }
    objf[b] = (float)(ll + tlp);
    // backward
    for (int i = 0; i < S; i++) bnext[i] = (double)fi[i] - tlp;
    for (int t = Tb - 1; t >= 0; t--) {
      const float* xrow = xb + (size_t)t * P;
      const double* at = alpha.data() + (size_t)t * S;
      float* grow = gb + (size_t)t * P;
      for (int i = 0; i < S; i++) bd[i] = ninf;
      for (int64_t a = 0; a < K; a++) {
        const int32_t* tr = ft + 3 * a;
        if (fp[a] == kNegInf) continue;
        const double vf = (double)fp[a] + bnext[tr[1]] + (double)xrow[tr[2]]
                          - asum[t];
        bd[tr[0]] = logadd(bd[tr[0]], vf);
        grow[tr[2]] += (float)std::exp(vf + at[tr[0]]);
      }
      std::swap(bd, bnext);
    }
  }
  return 0;
}

// ---------------------------------------------------------------------
// Kaldi feature matrices (data-loader fast path; kaldi_features.py is
// the behavioural spec).  Formats: FM (f32), DM (f64), CM/CM2/CM3
// (CompressedMatrix; see src/matrix/compressed-matrix.h).
// ---------------------------------------------------------------------

static int read_feat_header(FILE* f, char tok[4], int32_t* rows,
                            int32_t* cols, float* minv, float* rng) {
  // token is space-terminated
  int n = 0;
  for (;;) {
    int c = fgetc(f);
    if (c == EOF) return -1;
    if (c == ' ') break;
    if (n >= 3) return -1;
    tok[n++] = (char)c;
  }
  tok[n] = 0;
  if (!strcmp(tok, "FM") || !strcmp(tok, "DM")) {
    unsigned char sz;
    if (fread(&sz, 1, 1, f) != 1 || sz != 4) return -1;
    if (!read_pod(f, rows)) return -1;
    if (fread(&sz, 1, 1, f) != 1 || sz != 4) return -1;
    if (!read_pod(f, cols)) return -1;
    return 0;
  }
  if (!strcmp(tok, "CM") || !strcmp(tok, "CM2") || !strcmp(tok, "CM3")) {
    if (!read_pod(f, minv) || !read_pod(f, rng) || !read_pod(f, rows) ||
        !read_pod(f, cols)) return -1;
    return 0;
  }
  return -1;
}

// Validate a feature header's shape against the remaining payload:
// corrupted (negative/oversized) rows/cols must reject, not allocate
// or index out of bounds (fuzz hardening).
static int feat_shape_ok(FILE* f, const char tok[4], int32_t rows,
                         int32_t cols) {
  if (rows < 0 || cols < 0) return 0;
  long rem = remaining_bytes(f);
  if (rem < 0) return 0;
  const int64_t n = (int64_t)rows * cols;
  if (n > rem) return 0;  // every format needs >= 1 byte per element
  int64_t need;
  if (!strcmp(tok, "FM")) need = 4 * n;
  else if (!strcmp(tok, "DM")) need = 8 * n;
  else if (!strcmp(tok, "CM2")) need = 2 * n;
  else if (!strcmp(tok, "CM3")) need = n;
  else need = 8 * (int64_t)cols + n;  // CM: headers + codes
  return need <= rem;
}

// Probe a matrix at `offset` (pointing at the \0B marker): fills
// rows/cols.  Returns 0 ok, -1 on format error.
int pc_feats_probe(const char* path, long offset, int32_t* rows,
                   int32_t* cols) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  if (fseek(f, offset, SEEK_SET) != 0) { fclose(f); return -1; }
  unsigned char mk[2];
  if (fread(mk, 1, 2, f) != 2 || mk[0] != 0 || mk[1] != 'B') {
    fclose(f); return -1;
  }
  char tok[4];
  float minv, rng;
  int rc = read_feat_header(f, tok, rows, cols, &minv, &rng);
  if (rc == 0 && !feat_shape_ok(f, tok, *rows, *cols)) rc = -1;
  fclose(f);
  return rc;
}

// Read + decode one matrix at `offset` into out (rows*cols f32,
// row-major; caller sized it via pc_feats_probe).  Returns 0 ok.
int pc_feats_read(const char* path, long offset, float* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  if (fseek(f, offset, SEEK_SET) != 0) { fclose(f); return -1; }
  unsigned char mk[2];
  if (fread(mk, 1, 2, f) != 2 || mk[0] != 0 || mk[1] != 'B') {
    fclose(f); return -1;
  }
  char tok[4];
  int32_t rows = 0, cols = 0;
  float minv = 0, rng = 1;
  if (read_feat_header(f, tok, &rows, &cols, &minv, &rng) != 0 ||
      !feat_shape_ok(f, tok, rows, cols)) {
    fclose(f); return -1;
  }
  const int64_t n = (int64_t)rows * cols;
  auto fail = [&]() { fclose(f); return -1; };
  if (!strcmp(tok, "FM")) {
    if (fread(out, 4, n, f) != (size_t)n) return fail();
  } else if (!strcmp(tok, "DM")) {
    std::vector<double> d(n);
    if (fread(d.data(), 8, n, f) != (size_t)n) return fail();
    for (int64_t i = 0; i < n; i++) out[i] = (float)d[i];
  } else if (!strcmp(tok, "CM2")) {
    std::vector<uint16_t> u(n);
    if (fread(u.data(), 2, n, f) != (size_t)n) return fail();
    for (int64_t i = 0; i < n; i++)
      out[i] = minv + rng * u[i] / 65535.0f;
  } else if (!strcmp(tok, "CM3")) {
    std::vector<uint8_t> u(n);
    if (fread(u.data(), 1, n, f) != (size_t)n) return fail();
    for (int64_t i = 0; i < n; i++)
      out[i] = minv + rng * u[i] / 255.0f;
  } else {  // CM: Kaldi layout — ALL per-column percentile headers
             // first (cols x 4 uint16), then all code bytes, one
             // column after another (cols x rows uint8)
    std::vector<uint16_t> headers((size_t)cols * 4);
    std::vector<uint8_t> codes((size_t)cols * rows);
    if (fread(headers.data(), 2, headers.size(), f) != headers.size())
      return fail();
    if (fread(codes.data(), 1, codes.size(), f) != codes.size())
      return fail();
    for (int32_t c = 0; c < cols; c++) {
      const uint16_t* pu = headers.data() + (size_t)c * 4;
      float p[4];
      for (int i = 0; i < 4; i++)
        p[i] = minv + rng * pu[i] / 65535.0f;
      const uint8_t* code = codes.data() + (size_t)c * rows;
      for (int32_t r = 0; r < rows; r++) {
        float v, x = (float)code[r];
        if (x <= 64.0f)
          v = p[0] + (p[1] - p[0]) * (x / 64.0f);
        else if (x <= 192.0f)
          v = p[1] + (p[2] - p[1]) * ((x - 64.0f) / 128.0f);
        else
          v = p[2] + (p[3] - p[2]) * ((x - 192.0f) / 63.0f);
        out[(int64_t)r * cols + c] = v;
      }
    }
  }
  fclose(f);
  return 0;
}

// Scan a feature ark sequentially: write up to `cap` (offset, key)
// entries; keys are written NUL-terminated back to back into `keys`
// (capacity keys_cap).  Returns the number of entries found (even if
// > cap — call again with bigger buffers), -1 on a malformed entry,
// or -2 when `keys` is too small for the requested entries (call
// again with a larger keys_cap; partially-written keys must not be
// trusted).  A key is never silently dropped: that would misalign the
// NUL-delimited key list against the offsets array.
long pc_feats_scan(const char* path, long cap, int64_t* offsets,
                   char* keys, long keys_cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  long count = 0, kpos = 0;
  for (;;) {
    std::string key;
    int c = fgetc(f);
    if (c == EOF) break;
    while (c != ' ' && c != EOF) { key.push_back((char)c); c = fgetc(f); }
    if (c == EOF) { fclose(f); return -1; }
    long off = ftell(f);
    unsigned char mk[2];
    if (fread(mk, 1, 2, f) != 2 || mk[0] != 0 || mk[1] != 'B') {
      fclose(f); return -1;
    }
    char tok[4];
    int32_t rows = 0, cols = 0;
    float minv, rng;
    if (read_feat_header(f, tok, &rows, &cols, &minv, &rng) != 0) {
      fclose(f); return -1;
    }
    int64_t payload;
    if (!strcmp(tok, "FM")) payload = (int64_t)rows * cols * 4;
    else if (!strcmp(tok, "DM")) payload = (int64_t)rows * cols * 8;
    else if (!strcmp(tok, "CM2")) payload = (int64_t)rows * cols * 2;
    else if (!strcmp(tok, "CM3")) payload = (int64_t)rows * cols;
    else payload = (int64_t)cols * (8 + rows);
    if (fseek(f, payload, SEEK_CUR) != 0) { fclose(f); return -1; }
    if (count < cap && offsets) {
      offsets[count] = off;
      if (keys) {
        if (kpos + (long)key.size() + 1 > keys_cap) {
          fclose(f);
          return -2;
        }
        memcpy(keys + kpos, key.c_str(), key.size() + 1);
        kpos += key.size() + 1;
      }
    }
    count++;
  }
  fclose(f);
  return count;
}

}  // extern "C"

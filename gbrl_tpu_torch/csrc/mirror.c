/* Host predictor of the ensemble mirror (gbrl_tpu_torch/utils/host_mirror.py):
   the heap-layout tree walk and coefficient-weighted leaf sum that serve
   rollout forwards on the host.  The same C as gbrl_tpu/utils/host_mirror.py
   carries inline.  Built with: gcc -O2 -shared -fPIC mirror.c -lm */
#include <stdint.h>
#include <math.h>

/* Heap-layout greedy/oblivious tree walk + coefficient-weighted leaf sum.
   rel descends the implicit heap: pass-through (non-split) nodes descend
   left, numeric splits go right on x > thr, categorical on code equality
   (node.cpp:77-96 semantics). */
void gbrl_mirror_predict(
    const float *X,            /* [N, F] numeric features */
    const int32_t *Xc,         /* [N, Fc] categorical codes (or NULL) */
    int64_t N, int64_t F, int64_t Fc,
    const int32_t *feat,       /* [T, P] */
    const float *thr,          /* [T, P] */
    const uint8_t *split,      /* [T, P] */
    const uint8_t *isnum,      /* [T, P] */
    const int32_t *code,       /* [T, P] */
    const float *wleaf,        /* [T, L, O] coeff-premultiplied leaf values */
    int64_t T, int64_t D, int64_t O,
    const float *bias,         /* [O] */
    float *out)                /* [N, O] */
{
    int64_t P = (1LL << D) - 1;
    int64_t L = 1LL << D;
    for (int64_t n = 0; n < N; ++n) {
        const float *x = X + n * F;
        const int32_t *xc = Xc ? Xc + n * Fc : 0;
        float *o = out + n * O;
        for (int64_t j = 0; j < O; ++j) o[j] = bias[j];
        for (int64_t t = 0; t < T; ++t) {
            const int32_t *tf = feat + t * P;
            const float *tt = thr + t * P;
            const uint8_t *ts = split + t * P;
            const uint8_t *tn = isnum + t * P;
            const int32_t *tc = code + t * P;
            int64_t rel = 0;
            for (int64_t d = 0; d < D; ++d) {
                int64_t p = (1LL << d) - 1 + rel;
                int go = 0;
                if (ts[p]) {
                    int32_t f = tf[p];
                    if (tn[p]) go = x[f] > tt[p];
                    else       go = xc && xc[f] == tc[p];
                }
                rel = 2 * rel + go;
            }
            const float *w = wleaf + (t * L + rel) * O;
            for (int64_t j = 0; j < O; ++j) o[j] += w[j];
        }
    }
}

/* Mixed SGD/Adam forward: the Adam columns need the per-sample first/second
   moment recurrence over the tree sequence (reference optimizer.cpp:260-283:
   m_t = b1 m + (1-b1) g, v_t = b2 v + (1-b2) g^2, zero-initialized per call,
   theta -= alpha_t m/(sqrt(v)+eps) with alpha_t = lr(t)
   sqrt(1-b2^(t+1))/(1-b1^(t+1)) folded into alpha[t*O+j] on the host side).
   SGD columns keep the coefficient-premultiplied wleaf sum (alpha is zero
   there and wleaf is zero on Adam columns).  One tree walk serves both. */
void gbrl_mirror_predict_adam(
    const float *X, const int32_t *Xc,
    int64_t N, int64_t F, int64_t Fc,
    const int32_t *feat, const float *thr, const uint8_t *split,
    const uint8_t *isnum, const int32_t *code,
    const float *wleaf,        /* [T, L, O] SGD-premultiplied (0 on Adam) */
    const float *rawleaf,      /* [T, L, O] raw leaf values */
    const float *alpha,        /* [T, O] Adam step size (0 on SGD cols) */
    const float *b1, const float *b2, const float *eps,   /* [O] */
    const uint8_t *adam,       /* [O] column mask */
    int64_t T, int64_t D, int64_t O,
    const float *bias, float *out)
{
    int64_t P = (1LL << D) - 1;
    int64_t L = 1LL << D;
    for (int64_t n = 0; n < N; ++n) {
        const float *x = X + n * F;
        const int32_t *xc = Xc ? Xc + n * Fc : 0;
        float *o = out + n * O;
        float m[256], v[256];   /* caller guarantees O <= 256 */
        for (int64_t j = 0; j < O; ++j) { o[j] = bias[j]; m[j] = v[j] = 0.f; }
        for (int64_t t = 0; t < T; ++t) {
            const int32_t *tf = feat + t * P;
            const float *tt = thr + t * P;
            const uint8_t *ts = split + t * P;
            const uint8_t *tn = isnum + t * P;
            const int32_t *tc = code + t * P;
            int64_t rel = 0;
            for (int64_t d = 0; d < D; ++d) {
                int64_t p = (1LL << d) - 1 + rel;
                int go = 0;
                if (ts[p]) {
                    int32_t f = tf[p];
                    if (tn[p]) go = x[f] > tt[p];
                    else       go = xc && xc[f] == tc[p];
                }
                rel = 2 * rel + go;
            }
            const float *w = wleaf + (t * L + rel) * O;
            const float *g = rawleaf + (t * L + rel) * O;
            const float *a = alpha + t * O;
            for (int64_t j = 0; j < O; ++j) {
                if (adam[j]) {
                    float gj = g[j];
                    m[j] = b1[j] * m[j] + (1.f - b1[j]) * gj;
                    v[j] = b2[j] * v[j] + (1.f - b2[j]) * gj * gj;
                    o[j] -= a[j] * m[j] / (sqrtf(v[j]) + eps[j]);
                } else {
                    o[j] += w[j];
                }
            }
        }
    }
}

// Kalman filter / RTS smoother core of the host brain (f64).
//
// The port's copy of moseq2_detectron_extract_tpu/native/kalman_native.cpp,
// the same float64 math: the tracker recurrences of proc/kalman.py are
// sequential over time with a small (<= 54-dim) state, so per-op overhead
// dominates them in numpy. proc/kalman.py runs this core as its 'native'
// smoother backend; a return code other than 0 (a covariance that is not
// positive definite even with jitter) makes the caller redo the chunk with
// the numpy backend, counted and logged.
//
// Built by native.build_host_library with g++ -O3 -shared -fPIC -std=c++17
// (no -march=native), loaded through ctypes; a failed build raises.
#include <cmath>
#include <cstring>
#include <vector>

namespace {

// Cholesky decomposition of SPD matrix a (n x n), lower triangular in place.
// Returns false if not positive definite (caller adds jitter and retries).
bool cholesky(double* a, int n) {
    for (int i = 0; i < n; ++i) {
        for (int j = 0; j <= i; ++j) {
            double sum = a[i * n + j];
            for (int k = 0; k < j; ++k) sum -= a[i * n + k] * a[j * n + k];
            if (i == j) {
                if (sum <= 0.0) return false;
                a[i * n + i] = std::sqrt(sum);
            } else {
                a[i * n + j] = sum / a[j * n + j];
            }
        }
        for (int j = i + 1; j < n; ++j) a[i * n + j] = 0.0;
    }
    return true;
}

// Solve L L^T x = b for many right-hand sides: B is (n x m), overwritten.
void cholesky_solve(const double* L, double* B, int n, int m) {
    // forward: L y = b
    for (int c = 0; c < m; ++c) {
        for (int i = 0; i < n; ++i) {
            double sum = B[i * m + c];
            for (int k = 0; k < i; ++k) sum -= L[i * n + k] * B[k * m + c];
            B[i * m + c] = sum / L[i * n + i];
        }
        // backward: L^T x = y
        for (int i = n - 1; i >= 0; --i) {
            double sum = B[i * m + c];
            for (int k = i + 1; k < n; ++k) sum -= L[k * n + i] * B[k * m + c];
            B[i * m + c] = sum / L[i * n + i];
        }
    }
}

void matmul(const double* a, const double* b, double* out, int n, int k, int m) {
    // out (n x m) = a (n x k) @ b (k x m)
    for (int i = 0; i < n; ++i) {
        for (int j = 0; j < m; ++j) out[i * m + j] = 0.0;
        for (int p = 0; p < k; ++p) {
            const double av = a[i * k + p];
            if (av == 0.0) continue;
            const double* brow = b + p * m;
            double* orow = out + i * m;
            for (int j = 0; j < m; ++j) orow[j] += av * brow[j];
        }
    }
}

void matmul_tb(const double* a, const double* b, double* out, int n, int k, int m) {
    // out (n x m) = a (n x k) @ b^T where b is (m x k)
    for (int i = 0; i < n; ++i) {
        for (int j = 0; j < m; ++j) {
            double sum = 0.0;
            for (int p = 0; p < k; ++p) sum += a[i * k + p] * b[j * k + p];
            out[i * m + j] = sum;
        }
    }
}

void symmetrize(double* a, int n) {
    for (int i = 0; i < n; ++i)
        for (int j = 0; j < i; ++j) {
            double v = 0.5 * (a[i * n + j] + a[j * n + i]);
            a[i * n + j] = v;
            a[j * n + i] = v;
        }
}

}  // namespace

extern "C" {

// Forward filter.
// A (S,S), C (O,S), Q (S,S), R (O,O), mu0 (S), S0 (S,S)
// obs (T,O), missing (T) uint8
// outputs: means (T,S), covs (T,S,S), pred_means (T,S), pred_covs (T,S,S)
// First timestep updates the prior directly (no transition), matching the
// Python core. Returns 0 on success, nonzero on numerical failure.
int kalman_filter_native(const double* A, const double* C, const double* Q,
                         const double* R, const double* mu0, const double* S0,
                         const double* obs, const unsigned char* missing,
                         int T, int S, int O,
                         double* means, double* covs,
                         double* pred_means, double* pred_covs) {
    std::vector<double> innov(O), Svec(O * O), L(O * O), CP(O * S), K(S * O);
    std::vector<double> mean(S), cov(S * S), tmpS(S * S), tmpS2(S * S);

    auto update = [&](const double* pm, const double* pc, const double* y,
                      bool miss, double* out_mean, double* out_cov) -> int {
        if (miss) {
            std::memcpy(out_mean, pm, S * sizeof(double));
            std::memcpy(out_cov, pc, S * S * sizeof(double));
            return 0;
        }
        // innovation y - C mu
        for (int i = 0; i < O; ++i) {
            double s = y[i];
            for (int k = 0; k < S; ++k) s -= C[i * S + k] * pm[k];
            innov[i] = s;
        }
        // CP = C @ P (O x S);  Sm = CP @ C^T + R
        matmul(C, pc, CP.data(), O, S, S);
        matmul_tb(CP.data(), C, Svec.data(), O, S, O);
        for (int i = 0; i < O * O; ++i) Svec[i] += R[i];
        std::memcpy(L.data(), Svec.data(), O * O * sizeof(double));
        if (!cholesky(L.data(), O)) {
            for (int i = 0; i < O; ++i) Svec[i * O + i] += 1e-6;
            std::memcpy(L.data(), Svec.data(), O * O * sizeof(double));
            if (!cholesky(L.data(), O)) return 1;
        }
        // K^T = S^{-1} (C P)  -> solve S X = CP, X is (O x S); K = X^T
        std::vector<double> X(CP);
        cholesky_solve(L.data(), X.data(), O, S);
        // out_mean = pm + K innov = pm + X^T innov
        for (int k = 0; k < S; ++k) {
            double s = pm[k];
            for (int i = 0; i < O; ++i) s += X[i * S + k] * innov[i];
            out_mean[k] = s;
        }
        // out_cov = pc - K CP = pc - X^T CP
        for (int a = 0; a < S; ++a)
            for (int b = 0; b < S; ++b) {
                double s = pc[a * S + b];
                for (int i = 0; i < O; ++i) s -= X[i * S + a] * CP[i * S + b];
                out_cov[a * S + b] = s;
            }
        symmetrize(out_cov, S);
        return 0;
    };

    // t = 0
    std::memcpy(pred_means, mu0, S * sizeof(double));
    std::memcpy(pred_covs, S0, S * S * sizeof(double));
    if (update(mu0, S0, obs, missing[0] != 0, means, covs)) return 1;

    for (int t = 1; t < T; ++t) {
        const double* prev_mean = means + (t - 1) * S;
        const double* prev_cov = covs + (size_t)(t - 1) * S * S;
        double* pm = pred_means + t * S;
        double* pc = pred_covs + (size_t)t * S * S;
        // predict: pm = A prev_mean; pc = A prev_cov A^T + Q
        for (int i = 0; i < S; ++i) {
            double s = 0.0;
            for (int k = 0; k < S; ++k) s += A[i * S + k] * prev_mean[k];
            pm[i] = s;
        }
        matmul(A, prev_cov, tmpS.data(), S, S, S);
        matmul_tb(tmpS.data(), A, pc, S, S, S);
        for (int i = 0; i < S * S; ++i) pc[i] += Q[i];
        symmetrize(pc, S);

        if (update(pm, pc, obs + (size_t)t * O, missing[t] != 0,
                   means + (size_t)t * S, covs + (size_t)t * S * S))
            return 1;
    }
    return 0;
}

// RTS smoother; consumes filter outputs. lag (T-1, S, S) holds V_{t+1,t|T}.
int kalman_smooth_native(const double* A, const double* means, const double* covs,
                         const double* pred_means, const double* pred_covs,
                         int T, int S,
                         double* s_means, double* s_covs, double* lag) {
    std::vector<double> AP(S * S), L(S * S), J(S * S), diff(S), tmp(S * S),
        tmp2(S * S);

    std::memcpy(s_means + (size_t)(T - 1) * S, means + (size_t)(T - 1) * S,
                S * sizeof(double));
    std::memcpy(s_covs + (size_t)(T - 1) * S * S, covs + (size_t)(T - 1) * S * S,
                S * S * sizeof(double));

    for (int t = T - 2; t >= 0; --t) {
        const double* f_cov = covs + (size_t)t * S * S;
        const double* npc = pred_covs + (size_t)(t + 1) * S * S;
        // J = f_cov A^T (P_{t+1|t})^{-1}:  solve P X = A f_cov  (X = J^T)
        matmul(A, f_cov, AP.data(), S, S, S);
        std::memcpy(L.data(), npc, S * S * sizeof(double));
        if (!cholesky(L.data(), S)) {
            std::memcpy(L.data(), npc, S * S * sizeof(double));
            for (int i = 0; i < S; ++i) L[i * S + i] += 1e-6;
            if (!cholesky(L.data(), S)) return 1;
        }
        std::vector<double> X(AP);  // (S x S): solve P X = AP
        cholesky_solve(L.data(), X.data(), S, S);
        // J = X^T
        for (int a = 0; a < S; ++a)
            for (int b = 0; b < S; ++b) J[a * S + b] = X[b * S + a];

        // s_mean_t = f_mean + J (s_mean_{t+1} - pred_mean_{t+1})
        const double* nsm = s_means + (size_t)(t + 1) * S;
        const double* npm = pred_means + (size_t)(t + 1) * S;
        for (int i = 0; i < S; ++i) diff[i] = nsm[i] - npm[i];
        double* sm = s_means + (size_t)t * S;
        const double* fm = means + (size_t)t * S;
        for (int i = 0; i < S; ++i) {
            double s = fm[i];
            for (int k = 0; k < S; ++k) s += J[i * S + k] * diff[k];
            sm[i] = s;
        }
        // s_cov_t = f_cov + J (s_cov_{t+1} - P_{t+1|t}) J^T
        const double* nsc = s_covs + (size_t)(t + 1) * S * S;
        for (int i = 0; i < S * S; ++i) tmp[i] = nsc[i] - npc[i];
        matmul(J.data(), tmp.data(), tmp2.data(), S, S, S);
        double* sc = s_covs + (size_t)t * S * S;
        matmul_tb(tmp2.data(), J.data(), sc, S, S, S);
        for (int i = 0; i < S * S; ++i) sc[i] += f_cov[i];
        symmetrize(sc, S);

        // lag_t = s_cov_{t+1} J^T  (V_{t+1, t | T})
        matmul_tb(nsc, J.data(), lag + (size_t)t * S * S, S, S, S);
    }
    return 0;
}

}  // extern "C"

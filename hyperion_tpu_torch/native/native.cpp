// Native host kernels of the port: a copy of hyperion_tpu/native/native.cpp
// (C ABI, loaded with ctypes by hyperion_tpu_torch/native/__init__.py).
//
// These are the HOST-side hot loops that the reference implements as C
// extensions (_discretize_sph.c, _integrate_core.c, _interpolate_core.c).
// Everything is exposed with a plain C ABI so no Python headers are needed
// at build time and the library can be compiled with a bare g++.

#include <cmath>
#include <cstdint>

extern "C" {

// Exact SPH->cell mass discretization with a separable Gaussian kernel
// (ref _discretize_sph.c:180-210): cell i gains
//   0.125 * m_j * prod_axis |erf((hi-mu)/sqrt(2)sigma) - erf((lo-mu)/sqrt(2)sigma)|
// Particles farther than `cull` sigmas from a cell along any axis are
// skipped (the erf product is < 1e-12 there).
void hyp_discretize_sph(std::int64_t n_cells,
                        const double *xmin, const double *xmax,
                        const double *ymin, const double *ymax,
                        const double *zmin, const double *zmax,
                        std::int64_t n_part,
                        const double *mux, const double *muy,
                        const double *muz, const double *sigma,
                        const double *mass,
                        double cull,
                        double *total)
{
    const double inv_sqrt2 = 0.7071067811865475244;
    for (std::int64_t i = 0; i < n_cells; ++i) {
        double acc = 0.0;
        const double x0 = xmin[i], x1 = xmax[i];
        const double y0 = ymin[i], y1 = ymax[i];
        const double z0 = zmin[i], z1 = zmax[i];
        for (std::int64_t j = 0; j < n_part; ++j) {
            const double s = sigma[j];
            const double r = cull * s;
            if (mux[j] < x0 - r || mux[j] > x1 + r ||
                muy[j] < y0 - r || muy[j] > y1 + r ||
                muz[j] < z0 - r || muz[j] > z1 + r)
                continue;
            const double norm = inv_sqrt2 / s;
            const double fx = std::erf((x1 - mux[j]) * norm) -
                              std::erf((x0 - mux[j]) * norm);
            const double fy = std::erf((y1 - muy[j]) * norm) -
                              std::erf((y0 - muy[j]) * norm);
            const double fz = std::erf((z1 - muz[j]) * norm) -
                              std::erf((z0 - muz[j]) * norm);
            acc += std::fabs(fx * fy * fz) * 0.125 * mass[j];
        }
        total[i] = acc;
    }
}

// Piecewise power-law (log-log) integral of y(x) over the full x range
// (ref _integrate_core.c). Zero segments contribute zero, slope ~ -1
// segments integrate as x1*y1*ln(x2/x1).
double hyp_integrate_loglog(std::int64_t n, const double *x, const double *y)
{
    double total = 0.0;
    for (std::int64_t i = 0; i + 1 < n; ++i) {
        const double x1 = x[i], x2 = x[i + 1];
        const double y1 = y[i], y2 = y[i + 1];
        if (y1 <= 0.0 || y2 <= 0.0 || x2 <= x1)
            continue;
        const double b = std::log10(y2 / y1) / std::log10(x2 / x1);
        if (std::fabs(b + 1.0) < 1e-10)
            total += x1 * y1 * std::log(x2 / x1);
        else
            total += y1 * x1 / (b + 1.0) * (std::pow(x2 / x1, b + 1.0) - 1.0);
    }
    return total;
}

// Batched log-log interpolation: for each query q, locate x_t bracket by
// binary search and power-law interpolate (ref _interpolate_core.c
// interp1d_linlog/loglog family). Out-of-range queries clamp to the edges.
void hyp_interp_loglog(std::int64_t n_table, const double *x_t,
                       const double *y_t, std::int64_t n, const double *xq,
                       double *out)
{
    for (std::int64_t i = 0; i < n; ++i) {
        const double q = xq[i];
        if (q <= x_t[0]) { out[i] = y_t[0]; continue; }
        if (q >= x_t[n_table - 1]) { out[i] = y_t[n_table - 1]; continue; }
        std::int64_t lo = 0, hi = n_table - 1;
        while (hi - lo > 1) {
            const std::int64_t mid = (lo + hi) / 2;
            if (x_t[mid] <= q) lo = mid; else hi = mid;
        }
        const double y1 = y_t[lo], y2 = y_t[hi];
        if (y1 <= 0.0 || y2 <= 0.0) { out[i] = 0.0; continue; }
        const double f = std::log(q / x_t[lo]) / std::log(x_t[hi] / x_t[lo]);
        out[i] = y1 * std::pow(y2 / y1, f);
    }
}

}  // extern "C"

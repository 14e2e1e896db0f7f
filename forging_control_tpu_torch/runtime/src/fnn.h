// FNN policy inference — native C++ runtime.
//
// Deployment-side counterpart of forging_control_tpu/nn/fnn.py (reference:
// FNNModel, Supervised Learning/Functions.py:113-178): input scaling,
// 3 -> hidden ReLU (optionally weight-shared intermediate layers),
// linear output (no bias), hardtanh, inverse output scaling, saturation.
// Fixed-size buffers, zero allocation per step.
#pragma once

#include <algorithm>
#include <cstring>
#include <vector>

namespace forging {

struct FnnPolicy {
  int input_dim = 3;
  int hidden_dim = 50;
  int width_dim = 1;
  std::vector<double> w_in;    // (input_dim * hidden_dim), row-major [in][hid]
  std::vector<double> b_in;    // (hidden_dim)
  std::vector<double> w_int;   // (hidden_dim * hidden_dim)
  std::vector<double> b_int;   // (hidden_dim)
  std::vector<double> w_out;   // (hidden_dim)
  // MaxAbs-style affine scalers: transform(x) = (x - shift) / scale.
  double in_shift[3] = {0, 0, 0};
  double in_scale[3] = {1, 1, 1};
  double out_shift = 0.0, out_scale = 1.0;
  double lb = -0.2, ub = 0.2;  // closed-loop saturation (Main.py:122)

  mutable std::vector<double> h0, h1;  // scratch, sized once

  void init_scratch() const {
    h0.resize(hidden_dim);
    h1.resize(hidden_dim);
  }

  // features = [y_dot, z, ref] (physical units) -> command u (physical).
  double step(double y_dot, double z, double ref) const {
    const double f[3] = {(y_dot - in_shift[0]) / in_scale[0],
                         (z - in_shift[1]) / in_scale[1],
                         (ref - in_shift[2]) / in_scale[2]};
    double* h = h0.data();
    for (int j = 0; j < hidden_dim; ++j) {
      double acc = b_in[j];
      for (int i = 0; i < input_dim; ++i) acc += f[i] * w_in[i * hidden_dim + j];
      h[j] = acc > 0.0 ? acc : 0.0;
    }
    double* g = h1.data();
    for (int l = 1; l < width_dim; ++l) {
      for (int j = 0; j < hidden_dim; ++j) {
        double acc = b_int[j];
        for (int i = 0; i < hidden_dim; ++i)
          acc += h[i] * w_int[i * hidden_dim + j];
        g[j] = acc > 0.0 ? acc : 0.0;
      }
      std::swap(h, g);
    }
    double out = 0.0;
    for (int i = 0; i < hidden_dim; ++i) out += h[i] * w_out[i];
    out = std::clamp(out, -1.0, 1.0);          // hardtanh (scaled units)
    double u = out * out_scale + out_shift;    // inverse transform
    return std::clamp(u, lb, ub);
  }
};

}  // namespace forging

// Memory-mapped trajectory store — native dataset IO.
//
// Replaces the reference's pickled do-mpc result blobs (Data/*.pkl,
// README.md:85-90) with a flat binary format that a C++ generation loop
// can stream and NumPy can memory-map zero-copy:
//
//   [ magic "FCTS" | u32 version | u32 n_traj | u32 t_steps | u32 n_cols ]
//   [ n_cols x 16-byte zero-padded column names                          ]
//   [ float64 data, C-order (n_traj, t_steps, n_cols)                    ]
//
// The Python side (runtime.TrajStore) reads it with np.memmap; columns
// default to the reference result-dict schema (y, y_dot, p1, p2, z, ref,
// u, F_d — Generate Data/Functions.py:381-390).
#pragma once

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace forging {

constexpr char kTrajMagic[4] = {'F', 'C', 'T', 'S'};
constexpr uint32_t kTrajVersion = 1;
constexpr int kColNameLen = 16;

class TrajStoreWriter {
 public:
  TrajStoreWriter(const std::string& path, uint32_t n_traj, uint32_t t_steps,
                  const std::vector<std::string>& cols)
      : n_traj_(n_traj), t_steps_(t_steps), n_cols_(cols.size()) {
    f_ = std::fopen(path.c_str(), "wb");
    if (!f_) return;
    std::fwrite(kTrajMagic, 1, 4, f_);
    uint32_t hdr[4] = {kTrajVersion, n_traj, t_steps,
                       static_cast<uint32_t>(cols.size())};
    std::fwrite(hdr, sizeof(uint32_t), 4, f_);
    for (const auto& c : cols) {
      char buf[kColNameLen] = {0};
      std::strncpy(buf, c.c_str(), kColNameLen - 1);
      std::fwrite(buf, 1, kColNameLen, f_);
    }
  }

  ~TrajStoreWriter() { close(); }

  bool ok() const { return f_ != nullptr; }

  // Append one trajectory: row-major (t_steps, n_cols).
  bool append(const double* data) {
    if (!f_ || written_ >= n_traj_) return false;
    const size_t n = static_cast<size_t>(t_steps_) * n_cols_;
    if (std::fwrite(data, sizeof(double), n, f_) != n) return false;
    ++written_;
    return true;
  }

  void close() {
    if (f_) {
      std::fclose(f_);
      f_ = nullptr;
    }
  }

 private:
  std::FILE* f_ = nullptr;
  uint32_t n_traj_, t_steps_, n_cols_;
  uint32_t written_ = 0;
};

}  // namespace forging

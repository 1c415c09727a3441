// One call per serving batch: every row's peaks -> canonical SMILES.
//
// The port's host library links this file with native/assemble.cpp and
// native/smiles.cpp (utils/build.py). For each row it runs what the
// reference package's per-row path (abcnet_tpu/infer/assemble.py:
// assemble_smiles_native) runs through two ctypes calls: assemble_graph,
// then graph_to_smiles on its outputs. The whole batch is one foreign
// call, so the Python interpreter lock stays released from the first row
// to the last, and the loop's other thread runs meanwhile
// (__main__.img2smiles_loop).
//
// Both stages are the existing extern "C" functions; nothing here
// re-implements them, so every string is byte-equal to the per-row path.
// Both keep no state between calls but `const` tables.

#include <chrono>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// native/assemble.cpp
int32_t assemble_graph(
    const int32_t* atom_xy, const int32_t* atom_type,
    const int32_t* atom_charge, const int32_t* atom_hs,
    const uint8_t* atom_valid, int32_t ka,
    const int32_t* bond_xy, const float* bond_delta,
    const int32_t* bond_type, const uint8_t* bond_valid, int32_t kb,
    double* out_atom_pos, int32_t* out_atom_type,
    int32_t* out_atom_charge, int32_t* out_atom_hs,
    int32_t* out_bonds, int32_t* out_bond_type, int32_t* out_n_bonds,
    double overshoot_cap, const float* atom_sub, const float* bond_sub,
    double rematch_max, const float* bond_score,
    double vprune_score_max);

// native/smiles.cpp
int32_t graph_to_smiles(const double* pos, const int32_t* type_cls,
                        const int32_t* charge_cls, const int32_t* hs,
                        int32_t na, const int32_t* bond_pairs,
                        const int32_t* orders, int32_t nb,
                        int32_t perceive_stereo, int32_t salvage_aromatic,
                        char* out, int32_t cap);

}  // extern "C"

namespace {

// The peak arrays, in the order of infer/native.py:BATCH_FIELDS.
enum Field {
  kAtomXy,      // int32 [ka, 2]
  kAtomType,    // int32 [ka]
  kAtomCharge,  // int32 [ka]
  kAtomHs,      // int32 [ka]
  kAtomValid,   // uint8 [ka]
  kBondXy,      // int32 [kb, 2]
  kBondDelta,   // float32 [kb, 2]
  kBondType,    // int32 [kb]
  kBondValid,   // uint8 [kb]
  kBondScore,   // float32 [kb], may be null
  kAtomSub,     // float32 [ka, 2], may be null
  kBondSub,     // float32 [kb, 2], may be null
  kFields
};

// The largest SMILES a row may have, with its NUL: the reference
// package's per-row binding (abcnet_tpu/infer/native.py:
// graph_to_smiles_native) gives up there too, at its last retry.
constexpr int32_t kSmilesCap = 1 << 20;

template <typename T>
const T* row(const void* const* data, const int64_t* stride, Field f,
             int64_t r) {
  return data[f] ? static_cast<const T*>(data[f]) + r * stride[f] : nullptr;
}

int64_t ns_since(std::chrono::steady_clock::time_point t0) {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now() - t0).count();
}

}  // namespace

extern "C" {

// Assemble `n` rows of a peak batch into SMILES.
//
//   data[f], stride[f]: field f's array (enum Field) and its row stride
//     in elements; row r starts at data[f] + r * stride[f] and is
//     contiguous. Null data[kBondScore] / [kAtomSub] / [kBondSub] = absent.
//   ka, kb: the atom and bond slots a row.
//   overshoot_cap, rematch_max, vprune_score_max: as assemble_graph.
//   subcell: 0 ignores the sub-cell offsets even where given.
//   perceive_stereo, salvage_aromatic: as graph_to_smiles.
// Outputs:
//   out[0, cap): the rows' SMILES one after another, no separator;
//   offset[r], length[r]: row r's bytes in `out`, length -1 where the row
//     has no SMILES;
//   ns[0], ns[1]: the nanoseconds summed over the rows in assemble_graph
//     and in graph_to_smiles (steady clock).
// Returns the bytes the SMILES need. Where that exceeds `cap`, `out`
// holds only the rows that fit whole, and the caller calls again with a
// buffer of the returned size.
int64_t assemble_smiles_batch(
    int64_t n, int32_t ka, int32_t kb, const void* const* data,
    const int64_t* stride, double overshoot_cap, int32_t subcell,
    double rematch_max, double vprune_score_max, int32_t perceive_stereo,
    int32_t salvage_aromatic, char* out, int64_t cap, int64_t* offset,
    int32_t* length, int64_t* ns) {
  std::vector<double> pos(2 * static_cast<size_t>(ka));
  std::vector<int32_t> type(ka), charge(ka), hs(ka);
  std::vector<int32_t> bonds(2 * static_cast<size_t>(kb)), orders(kb);
  std::vector<char> smiles(kSmilesCap);
  int64_t used = 0;
  ns[0] = ns[1] = 0;
  for (int64_t r = 0; r < n; ++r) {
    auto t0 = std::chrono::steady_clock::now();
    int32_t nb = 0;
    int32_t na = assemble_graph(
        row<int32_t>(data, stride, kAtomXy, r),
        row<int32_t>(data, stride, kAtomType, r),
        row<int32_t>(data, stride, kAtomCharge, r),
        row<int32_t>(data, stride, kAtomHs, r),
        row<uint8_t>(data, stride, kAtomValid, r), ka,
        row<int32_t>(data, stride, kBondXy, r),
        row<float>(data, stride, kBondDelta, r),
        row<int32_t>(data, stride, kBondType, r),
        row<uint8_t>(data, stride, kBondValid, r), kb, pos.data(),
        type.data(), charge.data(), hs.data(), bonds.data(), orders.data(),
        &nb, overshoot_cap,
        subcell ? row<float>(data, stride, kAtomSub, r) : nullptr,
        subcell ? row<float>(data, stride, kBondSub, r) : nullptr,
        rematch_max, row<float>(data, stride, kBondScore, r),
        vprune_score_max);
    ns[0] += ns_since(t0);
    int32_t len = -1;
    if (na >= 0) {
      auto t1 = std::chrono::steady_clock::now();
      len = graph_to_smiles(pos.data(), type.data(), charge.data(),
                            hs.data(), na, bonds.data(), orders.data(), nb,
                            perceive_stereo, salvage_aromatic, smiles.data(),
                            kSmilesCap);
      ns[1] += ns_since(t1);
      if (len < 0) len = -1;
    }
    offset[r] = used;
    length[r] = len;
    if (len > 0) {
      if (used + len <= cap) std::memcpy(out + used, smiles.data(), len);
      used += len;
    }
  }
  return used;
}

}  // extern "C"

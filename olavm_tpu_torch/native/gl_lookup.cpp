// Exact halo2-lookup permuted-columns construction, matching the reference
// merge-walk bit-for-bit (circuits/src/stark/lookup.rs:69-134): sort both
// columns, consume table copies on equality, spill skipped table values to a
// LIFO stack, and back-fill unmatched input slots from the stack plus the
// ascending table tail. The fill order changes the committed trace columns,
// so transcript bit-exactness vs the reference requires this exact order.

#include <algorithm>
#include <cstdint>
#include <vector>

typedef uint64_t u64;

extern "C" {

// inputs/table: length n (already canonical u64). Writes sorted_inputs and
// permuted_table (each length n). Returns 0, or -1 if an input value is
// missing from the table (lookup unsatisfiable).
int permuted_cols(const u64* inputs, const u64* table, u64 n,
                  u64* sorted_inputs, u64* permuted_table) {
    std::vector<u64> si(inputs, inputs + n);
    std::vector<u64> st(table, table + n);
    std::sort(si.begin(), si.end());
    std::sort(st.begin(), st.end());

    std::vector<u64> unused_inds;
    std::vector<u64> unused_vals;
    unused_inds.reserve(n);
    unused_vals.reserve(n);
    u64 i = 0, j = 0;
    while (i < n && j < n) {
        if (si[i] > st[j]) {
            unused_vals.push_back(st[j]);
            j++;
        } else if (si[i] < st[j]) {
            if (!unused_vals.empty()) {
                permuted_table[i] = unused_vals.back();
                unused_vals.pop_back();
            } else {
                unused_inds.push_back(i);
            }
            i++;
        } else {
            permuted_table[i] = st[j];
            i++;
            j++;
        }
    }
    for (; j < n; j++) unused_vals.push_back(st[j]);
    for (; i < n; i++) unused_inds.push_back(i);
    if (unused_inds.size() != unused_vals.size()) return -1;
    for (u64 k = 0; k < unused_inds.size(); k++) {
        permuted_table[unused_inds[k]] = unused_vals[k];
    }
    // zip_eq semantics hold; validity (every matched slot) is enforced by
    // the AIR constraints — mirror the reference, which does not re-check.
    for (u64 k = 0; k < n; k++) sorted_inputs[k] = si[k];
    return 0;
}

}  // extern "C"

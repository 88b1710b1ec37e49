// Native inverted-index BoW database (copy of cvids_tpu/native/bow.cpp, so
// that the port builds it without the JAX package; built by
// cvids_tpu_torch/_build.py with the host's C++ compiler).
//
// C++ counterpart of the reference's DBoW2 TemplatedDatabase
// (server_pose_graph/ThirdParty/DBoW/TemplatedDatabase.h:
// 607-728): sparse BoW vectors are indexed by word -> (entry, weight)
// postings; an L1-scored query touches only entries sharing words with the
// query, which beats the dense-matrix scan once the database grows to
// thousands of keyframes with sparse vectors. Entry exclusion (the
// reference's max_id argument) is a per-query id threshold.
//
// C ABI with an opaque handle, ctypes-friendly.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Posting {
  int32_t entry;
  float weight;
};

struct Db {
  int num_words;
  std::vector<std::vector<Posting>> index;  // word -> postings
  std::vector<float> norm;                  // entry -> L1 norm (should be 1)
  std::vector<int32_t> client;              // entry -> client id
  int32_t count = 0;
};

}  // namespace

extern "C" {

void* cvids_bow_create(int num_words) {
  Db* db = new Db();
  db->num_words = num_words;
  db->index.resize(num_words);
  return db;
}

void cvids_bow_destroy(void* h) { delete (Db*)h; }

// vec: sparse as (word_ids[i], weights[i]) pairs, nnz entries; returns entry id
int cvids_bow_add(void* h, const int32_t* words, const float* weights, int nnz,
                  int32_t client_id) {
  Db* db = (Db*)h;
  int32_t e = db->count++;
  float n = 0.f;
  for (int i = 0; i < nnz; ++i) {
    db->index[words[i]].push_back({e, weights[i]});
    n += weights[i] > 0 ? weights[i] : -weights[i];
  }
  db->norm.push_back(n);
  db->client.push_back(client_id);
  return e;
}

// L1 score (DBoW2): s = 1 - 0.5 * |q - d|_1 over normalized vectors.
// Using |q - d|_1 = 2 - 2 * sum_shared min(q_w, d_w) for L1-normalized
// vectors with disjoint-support terms expanded:
//   |q-d|_1 = sum_w |q_w - d_w| = |q|_1 + |d|_1 - 2*sum_shared min(q_w,d_w)
// => s = sum_shared min(q_w, d_w)   (for unit-norm inputs)
// Results for entries with id >= exclude_from or matching exclude_client
// recency rules are the caller's concern; we expose a simple id threshold.
void cvids_bow_query(void* h, const int32_t* words, const float* weights,
                     int nnz, int32_t exclude_from, float* scores_out,
                     int32_t scores_len) {
  Db* db = (Db*)h;
  for (int i = 0; i < scores_len; ++i) scores_out[i] = 0.f;
  int32_t cap = db->count < scores_len ? db->count : scores_len;
  for (int i = 0; i < nnz; ++i) {
    const float qw = weights[i];
    const auto& post = db->index[words[i]];
    for (const Posting& p : post) {
      if (p.entry >= cap) continue;
      if (exclude_from >= 0 && p.entry >= exclude_from) continue;
      scores_out[p.entry] += qw < p.weight ? qw : p.weight;
    }
  }
}

int cvids_bow_count(void* h) { return ((Db*)h)->count; }

}  // extern "C"

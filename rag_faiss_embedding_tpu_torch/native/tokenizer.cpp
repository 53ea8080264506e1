// Fast WordPiece tokenizer — native host-side component.
//
// The tokenizer is the host-side hot loop of the serving path (every query
// is tokenized before the TPU forward; reference: HF tokenizer call at
// vectorization.py:29-35). This C++ implementation handles the ASCII fast
// path (the overwhelming case for queries); any input containing non-ASCII
// bytes returns -1 and the caller falls back to the Python reference
// implementation (models/tokenizer.py), guaranteeing exact parity.
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in this image).
//
// A copy of rag_faiss_embedding_tpu/native/tokenizer.cpp. Built at first use
// by rag_faiss_embedding_tpu_torch/native/__init__.py (the host C++ compiler,
// -O3 -shared -fPIC) into rag_faiss_embedding_tpu_torch/_build/.

#include <cctype>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Tokenizer {
  std::unordered_map<std::string, int32_t> vocab;
  int32_t pad_id = 0, unk_id = 1, cls_id = 2, sep_id = 3;
  size_t max_token_chars = 0;   // longest vocab entry (sans "##")
  size_t max_word_chars = 100;  // words longer than this -> [UNK]
  bool lowercase = true;
};

inline bool is_ascii_punct(unsigned char c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

// Greedy longest-match WordPiece over one word; appends ids.
// Returns false if the word cannot be segmented (caller emits [UNK]).
bool wordpiece(const Tokenizer& t, const char* w, size_t n,
               std::vector<int32_t>& out) {
  size_t start = 0;
  size_t emitted = out.size();
  std::string piece;
  while (start < n) {
    size_t best_end = 0;
    int32_t best_id = -1;
    size_t max_end = n;
    // bound the probe length by the longest vocab entry
    if (t.max_token_chars && start + t.max_token_chars < max_end)
      max_end = start + t.max_token_chars;
    for (size_t end = max_end; end > start; --end) {
      piece.clear();
      if (start > 0) piece.append("##");
      piece.append(w + start, end - start);
      auto it = t.vocab.find(piece);
      if (it != t.vocab.end()) {
        best_end = end;
        best_id = it->second;
        break;
      }
    }
    if (best_id < 0) {
      out.resize(emitted);
      return false;
    }
    out.push_back(best_id);
    start = best_end;
  }
  return true;
}

}  // namespace

extern "C" {

void* wp_create(const char* vocab_lines, int lowercase) {
  auto* t = new Tokenizer();
  t->lowercase = lowercase != 0;
  const char* p = vocab_lines;
  int32_t id = 0;
  while (*p) {
    const char* nl = strchr(p, '\n');
    size_t len = nl ? static_cast<size_t>(nl - p) : strlen(p);
    if (len > 0) {
      std::string tok(p, len);
      t->vocab.emplace(tok, id);
      size_t chars = tok.rfind("##", 0) == 0 ? tok.size() - 2 : tok.size();
      if (chars > t->max_token_chars) t->max_token_chars = chars;
      if (tok == "[PAD]") t->pad_id = id;
      else if (tok == "[UNK]") t->unk_id = id;
      else if (tok == "[CLS]") t->cls_id = id;
      else if (tok == "[SEP]") t->sep_id = id;
      ++id;
    } else {
      ++id;  // empty line still consumes an id slot (vocab.txt line = id)
    }
    if (!nl) break;
    p = nl + 1;
  }
  return t;
}

void wp_free(void* handle) { delete static_cast<Tokenizer*>(handle); }

// Encode text -> ids with [CLS]/[SEP], truncated to max_len.
// Returns the id count, or -1 if the text needs the Python fallback
// (non-ASCII bytes present).
int32_t wp_encode(void* handle, const char* text, int32_t max_len,
                  int32_t* out_ids) {
  const Tokenizer& t = *static_cast<Tokenizer*>(handle);
  size_t n = strlen(text);
  for (size_t i = 0; i < n; ++i) {
    if (static_cast<unsigned char>(text[i]) >= 0x80) return -1;
  }
  std::vector<int32_t> ids;
  ids.reserve(static_cast<size_t>(max_len));
  ids.push_back(t.cls_id);

  std::string word;
  std::vector<int32_t> scratch;
  auto flush_word = [&]() {
    if (word.empty()) return;
    if (word.size() > t.max_word_chars) {
      ids.push_back(t.unk_id);
    } else {
      scratch.clear();
      if (wordpiece(t, word.data(), word.size(), scratch)) {
        ids.insert(ids.end(), scratch.begin(), scratch.end());
      } else {
        ids.push_back(t.unk_id);
      }
    }
    word.clear();
  };

  for (size_t i = 0; i < n && ids.size() < static_cast<size_t>(max_len) - 1;
       ++i) {
    unsigned char c = static_cast<unsigned char>(text[i]);
    if (c == 0 || iscntrl(c)) { flush_word(); continue; }
    if (isspace(c)) { flush_word(); continue; }
    if (is_ascii_punct(c)) {
      flush_word();
      std::string p(1, static_cast<char>(c));
      auto it = t.vocab.find(p);
      ids.push_back(it != t.vocab.end() ? it->second : t.unk_id);
      continue;
    }
    word.push_back(t.lowercase ? static_cast<char>(tolower(c))
                               : static_cast<char>(c));
  }
  if (ids.size() < static_cast<size_t>(max_len) - 1) flush_word();

  if (ids.size() > static_cast<size_t>(max_len) - 1)
    ids.resize(static_cast<size_t>(max_len) - 1);
  ids.push_back(t.sep_id);

  for (size_t i = 0; i < ids.size(); ++i) out_ids[i] = ids[i];
  return static_cast<int32_t>(ids.size());
}

// Batched encode into a padded (n_texts, max_len) int32 matrix + mask.
// texts: concatenated NUL-terminated strings. Returns 0 on success, -1 if
// any text needs the Python fallback (nothing is written in that case for
// that row; fallback_flags marks it).
int32_t wp_encode_batch(void* handle, const char* texts, int32_t n_texts,
                        int32_t max_len, int32_t pad_id, int32_t* out_ids,
                        int32_t* out_mask, int32_t* fallback_flags) {
  const char* p = texts;
  int32_t any_fallback = 0;
  for (int32_t r = 0; r < n_texts; ++r) {
    int32_t* row = out_ids + static_cast<size_t>(r) * max_len;
    int32_t* mrow = out_mask + static_cast<size_t>(r) * max_len;
    for (int32_t j = 0; j < max_len; ++j) { row[j] = pad_id; mrow[j] = 0; }
    int32_t count = wp_encode(handle, p, max_len, row);
    if (count < 0) {
      fallback_flags[r] = 1;
      any_fallback = -1;
    } else {
      fallback_flags[r] = 0;
      for (int32_t j = 0; j < count; ++j) mrow[j] = 1;
    }
    p += strlen(p) + 1;
  }
  return any_fallback;
}

}  // extern "C"

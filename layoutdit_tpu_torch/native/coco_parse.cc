// Native COCO annotations parser.
//
// The reference parses the full annotations JSON with Python json
// (publay_dataset.py:23-39): at PubLayNet scale that is a GB-plus file
// whose byte count is dominated by segmentation polygons the detection
// pipeline never reads. This scanner extracts ONLY the fields the
// framework uses — images {id, width, height, file_name}, annotations
// {id, image_id, category_id, bbox, area, iscrowd}, and the raw
// "categories" subtree — into packed arrays, skipping everything else
// at memchr speed. No PyObject per polygon vertex: both parse time and
// resident memory drop by multiples.
//
// Strictness contract: anything surprising (missing required field,
// non-numeric id, malformed escape, truncated input) fails the WHOLE
// parse; the Python caller falls back to json.load. The differential
// test (tests/test_coco_native.py) holds this parser equal to the
// Python extraction on everything it accepts.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Result {
  std::vector<int64_t> img_id;
  std::vector<int32_t> img_w, img_h;
  std::string img_names;              // concatenated UTF-8
  std::vector<int64_t> img_name_off;  // N+1 offsets into img_names
  std::vector<int64_t> ann_id, ann_img;
  std::vector<int32_t> ann_cat;
  std::vector<int8_t> ann_crowd;
  std::vector<double> ann_bbox;  // 4 * M (double: bitwise parity
                                 // with the Python json fallback)
  std::vector<double> ann_area;
  std::string categories_json;   // raw JSON subtree
};

struct Parser {
  const char* p;
  const char* end;
  bool ok = true;

  explicit Parser(const char* buf, long n) : p(buf), end(buf + n) {}

  void fail() { ok = false; p = end; }

  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
  }

  bool eat(char c) {
    ws();
    if (p < end && *p == c) { ++p; return true; }
    fail();
    return false;
  }

  bool peek(char c) {
    ws();
    return p < end && *p == c;
  }

  // ---- strings ------------------------------------------------------
  // Parse a JSON string into out (UTF-8). Handles standard escapes and
  // \uXXXX incl. surrogate pairs; anything else fails the parse.
  bool str(std::string* out) {
    if (!eat('"')) return false;
    while (p < end) {
      unsigned char c = (unsigned char)*p;
      if (c == '"') { ++p; return true; }
      if (c == '\\') {
        ++p;
        if (p >= end) break;
        char e = *p++;
        switch (e) {
          case '"': out->push_back('"'); break;
          case '\\': out->push_back('\\'); break;
          case '/': out->push_back('/'); break;
          case 'b': out->push_back('\b'); break;
          case 'f': out->push_back('\f'); break;
          case 'n': out->push_back('\n'); break;
          case 'r': out->push_back('\r'); break;
          case 't': out->push_back('\t'); break;
          case 'u': {
            unsigned cp;
            if (!hex4(&cp)) { fail(); return false; }
            if (cp >= 0xD800 && cp <= 0xDBFF) {  // high surrogate
              if (p + 1 >= end || p[0] != '\\' || p[1] != 'u') { fail(); return false; }
              p += 2;
              unsigned lo;
              if (!hex4(&lo) || lo < 0xDC00 || lo > 0xDFFF) { fail(); return false; }
              cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
            } else if (cp >= 0xDC00 && cp <= 0xDFFF) {
              fail(); return false;  // lone low surrogate
            }
            utf8(cp, out);
            break;
          }
          default: fail(); return false;
        }
      } else {
        out->push_back((char)c);
        ++p;
      }
    }
    fail();
    return false;
  }

  bool hex4(unsigned* out) {
    if (p + 4 > end) return false;
    unsigned v = 0;
    for (int i = 0; i < 4; ++i) {
      char c = p[i];
      v <<= 4;
      if (c >= '0' && c <= '9') v |= (unsigned)(c - '0');
      else if (c >= 'a' && c <= 'f') v |= (unsigned)(c - 'a' + 10);
      else if (c >= 'A' && c <= 'F') v |= (unsigned)(c - 'A' + 10);
      else return false;
    }
    p += 4;
    *out = v;
    return true;
  }

  static void utf8(unsigned cp, std::string* out) {
    if (cp < 0x80) {
      out->push_back((char)cp);
    } else if (cp < 0x800) {
      out->push_back((char)(0xC0 | (cp >> 6)));
      out->push_back((char)(0x80 | (cp & 0x3F)));
    } else if (cp < 0x10000) {
      out->push_back((char)(0xE0 | (cp >> 12)));
      out->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
      out->push_back((char)(0x80 | (cp & 0x3F)));
    } else {
      out->push_back((char)(0xF0 | (cp >> 18)));
      out->push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
      out->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
      out->push_back((char)(0x80 | (cp & 0x3F)));
    }
  }

  // Skip a string without materializing it (fast path for skipped keys:
  // only needs to honor escapes so a \" does not end the scan).
  bool skip_str() {
    if (!eat('"')) return false;
    while (p < end) {
      const char* q = (const char*)memchr(p, '"', (size_t)(end - p));
      if (!q) break;
      // count preceding backslashes to see if this quote is escaped
      const char* b = q;
      while (b > p && b[-1] == '\\') --b;
      p = q + 1;
      if (((q - b) & 1) == 0) return true;  // even # of backslashes
    }
    fail();
    return false;
  }

  // ---- numbers ------------------------------------------------------
  bool number(double* out) {
    ws();
    char* endp = nullptr;
    double v = strtod(p, &endp);
    if (endp == p || endp > end) { fail(); return false; }
    p = endp;
    *out = v;
    return true;
  }

  bool integer(int64_t* out) {
    ws();
    const char* q = p;
    if (q < end && *q == '-') ++q;
    while (q < end && *q >= '0' && *q <= '9') ++q;
    // ids encoded as floats ("1.0") or strings are not ints: fail ->
    // the Python fallback handles exotic files
    if (q == p || (q < end && (*q == '.' || *q == 'e' || *q == 'E'))) {
      fail();
      return false;
    }
    *out = strtoll(p, nullptr, 10);
    p = q;
    return true;
  }

  // ---- generic skipping ---------------------------------------------
  bool skip_value() {
    ws();
    if (p >= end) { fail(); return false; }
    char c = *p;
    if (c == '"') return skip_str();
    if (c == '{' || c == '[') {
      char open = c, close = (c == '{') ? '}' : ']';
      int depth = 0;
      // strings are the only construct that can contain brackets
      while (p < end) {
        char d = *p;
        if (d == '"') {
          if (!skip_str()) return false;
          continue;
        }
        if (d == open) ++depth;
        else if (d == close) {
          if (--depth == 0) { ++p; return true; }
        }
        ++p;
      }
      fail();
      return false;
    }
    if (strncmp(p, "true", 4) == 0 && p + 4 <= end) { p += 4; return true; }
    if (strncmp(p, "null", 4) == 0 && p + 4 <= end) { p += 4; return true; }
    if (strncmp(p, "false", 5) == 0 && p + 5 <= end) { p += 5; return true; }
    double d;
    return number(&d);
  }

  // ---- COCO-specific objects ----------------------------------------
  bool image_obj(Result* r) {
    if (!eat('{')) return false;
    int64_t id = 0;
    double w = -1, h = -1;
    std::string name;
    bool has_id = false, has_name = false;
    if (peek('}')) { fail(); return false; }  // empty image record
    for (;;) {
      std::string key;
      if (!str(&key)) return false;
      if (!eat(':')) return false;
      if (key == "id") { if (!integer(&id)) return false; has_id = true; }
      else if (key == "width") { if (!number(&w)) return false; }
      else if (key == "height") { if (!number(&h)) return false; }
      else if (key == "file_name") { if (!str(&name)) return false; has_name = true; }
      else if (!skip_value()) return false;
      ws();
      if (p < end && *p == ',') { ++p; continue; }
      if (p < end && *p == '}') { ++p; break; }
      fail();
      return false;
    }
    // strictness: non-integral or out-of-range sizes fall back to the
    // Python parser rather than silently truncating (they feed box
    // rescaling — a native/fallback divergence would shift metrics)
    if (!has_id || !has_name || w < 0 || h < 0 ||
        w != (double)(int32_t)w || h != (double)(int32_t)h) {
      fail();
      return false;
    }
    r->img_id.push_back(id);
    r->img_w.push_back((int32_t)w);
    r->img_h.push_back((int32_t)h);
    r->img_names += name;
    r->img_name_off.push_back((int64_t)r->img_names.size());
    return true;
  }

  bool ann_obj(Result* r) {
    if (!eat('{')) return false;
    int64_t id = 0, img = 0, cat = 0, crowd = 0;
    double area = -1, bbox[4];
    bool has_id = false, has_img = false, has_cat = false, has_bbox = false,
         has_area = false;
    if (peek('}')) { fail(); return false; }
    for (;;) {
      std::string key;
      if (!str(&key)) return false;
      if (!eat(':')) return false;
      if (key == "id") { if (!integer(&id)) return false; has_id = true; }
      else if (key == "image_id") { if (!integer(&img)) return false; has_img = true; }
      else if (key == "category_id") { if (!integer(&cat)) return false; has_cat = true; }
      else if (key == "iscrowd") { if (!integer(&crowd)) return false; }
      else if (key == "area") { if (!number(&area)) return false; has_area = true; }
      else if (key == "bbox") {
        if (!eat('[')) return false;
        for (int i = 0; i < 4; ++i) {
          if (!number(&bbox[i])) return false;
          if (i < 3 && !eat(',')) return false;
        }
        if (!eat(']')) return false;
        has_bbox = true;
      } else if (!skip_value()) {
        return false;
      }
      ws();
      if (p < end && *p == ',') { ++p; continue; }
      if (p < end && *p == '}') { ++p; break; }
      fail();
      return false;
    }
    if (!has_id || !has_img || !has_cat || !has_bbox || !has_area) {
      fail();
      return false;
    }
    r->ann_id.push_back(id);
    r->ann_img.push_back(img);
    r->ann_cat.push_back((int32_t)cat);
    r->ann_crowd.push_back((int8_t)crowd);
    r->ann_area.push_back(area);
    for (int i = 0; i < 4; ++i) r->ann_bbox.push_back(bbox[i]);
    return true;
  }

  template <typename F>
  bool array_of(F f) {
    if (!eat('[')) return false;
    if (peek(']')) { ++p; return true; }
    for (;;) {
      if (!f()) return false;
      ws();
      if (p < end && *p == ',') { ++p; continue; }
      if (p < end && *p == ']') { ++p; return true; }
      fail();
      return false;
    }
  }

  bool parse(Result* r) {
    r->img_name_off.push_back(0);
    if (!eat('{')) return false;
    if (peek('}')) { fail(); return false; }  // no sections at all
    bool saw_images = false, saw_anns = false, saw_cats = false;
    for (;;) {
      std::string key;
      if (!str(&key)) return false;
      if (!eat(':')) return false;
      if (key == "images") {
        saw_images = true;
        if (!array_of([&] { return image_obj(r); })) return false;
      } else if (key == "annotations") {
        saw_anns = true;
        if (!array_of([&] { return ann_obj(r); })) return false;
      } else if (key == "categories") {
        saw_cats = true;
        ws();
        const char* start = p;
        if (!skip_value()) return false;
        r->categories_json.assign(start, (size_t)(p - start));
      } else if (!skip_value()) {
        return false;
      }
      ws();
      if (p < end && *p == ',') { ++p; continue; }
      if (p < end && *p == '}') { ++p; break; }
      fail();
      return false;
    }
    ws();
    if (p != end) { fail(); return false; }  // trailing garbage
    if (!saw_images || !saw_anns || !saw_cats) { fail(); return false; }
    return ok;
  }
};

}  // namespace

extern "C" {

void* ld_coco_parse(const char* buf, long n) {
  Result* r = new Result();
  Parser parser(buf, n);
  if (!parser.parse(r)) {
    delete r;
    return nullptr;
  }
  return r;
}

void ld_coco_free(void* h) { delete (Result*)h; }

long ld_coco_n_images(void* h) { return (long)((Result*)h)->img_id.size(); }
long ld_coco_n_anns(void* h) { return (long)((Result*)h)->ann_id.size(); }
long ld_coco_names_bytes(void* h) {
  return (long)((Result*)h)->img_names.size();
}
long ld_coco_categories_bytes(void* h) {
  return (long)((Result*)h)->categories_json.size();
}

// Bulk copy-out into caller-allocated numpy buffers (one memcpy each).
void ld_coco_fill(void* h, int64_t* img_id, int32_t* img_w, int32_t* img_h,
                  int64_t* name_off, char* names, int64_t* ann_id,
                  int64_t* ann_img, int32_t* ann_cat, int8_t* ann_crowd,
                  double* ann_bbox, double* ann_area, char* categories) {
  Result* r = (Result*)h;
  auto cp = [](void* dst, const void* src, size_t nbytes) {
    if (nbytes) memcpy(dst, src, nbytes);
  };
  cp(img_id, r->img_id.data(), r->img_id.size() * 8);
  cp(img_w, r->img_w.data(), r->img_w.size() * 4);
  cp(img_h, r->img_h.data(), r->img_h.size() * 4);
  cp(name_off, r->img_name_off.data(), r->img_name_off.size() * 8);
  cp(names, r->img_names.data(), r->img_names.size());
  cp(ann_id, r->ann_id.data(), r->ann_id.size() * 8);
  cp(ann_img, r->ann_img.data(), r->ann_img.size() * 8);
  cp(ann_cat, r->ann_cat.data(), r->ann_cat.size() * 4);
  cp(ann_crowd, r->ann_crowd.data(), r->ann_crowd.size());
  cp(ann_bbox, r->ann_bbox.data(), r->ann_bbox.size() * 8);
  cp(ann_area, r->ann_area.data(), r->ann_area.size() * 8);
  cp(categories, r->categories_json.data(), r->categories_json.size());
}

}  // extern "C"

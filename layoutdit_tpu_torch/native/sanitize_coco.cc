// Sanitizer harness for the port's native COCO parser (coco_parse.cc):
// the COCO half of the JAX package's native/sanitize_main.cc. It is
// compiled together with coco_parse.cc under ASan+UBSan by
// tests/test_torch_sanitizers.py and run over a hostile corpus.
//
//   sanitize_coco <file...>   parse each file, copy the arrays out, free
//
// Exit 0 means no crash and no sanitizer report (the sanitizers abort
// with a nonzero code on a finding). A parse that fails is fine: most of
// the corpus is malformed on purpose. The last line is
// "coco: <parsed>/<files> parsed".

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>

extern "C" {
void* ld_coco_parse(const char* buf, long n);
void ld_coco_free(void* h);
long ld_coco_n_images(void* h);
long ld_coco_n_anns(void* h);
long ld_coco_names_bytes(void* h);
long ld_coco_categories_bytes(void* h);
void ld_coco_fill(void* h, int64_t* img_id, int32_t* img_w, int32_t* img_h,
                  int64_t* name_off, char* names, int64_t* ann_id,
                  int64_t* ann_img, int32_t* ann_cat, int8_t* ann_crowd,
                  double* ann_bbox, double* ann_area, char* categories);
}

static std::string read_file(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) {
    fprintf(stderr, "cannot open %s\n", path);
    exit(2);
  }
  std::string out;
  char buf[1 << 16];
  size_t n;
  while ((n = fread(buf, 1, sizeof(buf), f)) > 0) out.append(buf, n);
  fclose(f);
  return out;
}

int main(int argc, char** argv) {
  int parsed = 0;
  for (int i = 1; i < argc; ++i) {
    std::string raw = read_file(argv[i]);
    // as CPython's bytes: a NUL after the data (the number scanner
    // relies on it)
    raw.push_back('\0');
    void* h = ld_coco_parse(raw.data(), (long)raw.size() - 1);
    if (!h) continue;
    ++parsed;
    long n = ld_coco_n_images(h), m = ld_coco_n_anns(h);
    long nb = ld_coco_names_bytes(h), cb = ld_coco_categories_bytes(h);
    std::vector<int64_t> img_id(n), name_off(n + 1), ann_id(m), ann_img(m);
    std::vector<int32_t> img_w(n), img_h(n), ann_cat(m);
    std::vector<int8_t> ann_crowd(m);
    std::vector<double> ann_bbox(4 * m), ann_area(m);
    std::vector<char> names(nb ? nb : 1), cats(cb ? cb : 1);
    ld_coco_fill(h, img_id.data(), img_w.data(), img_h.data(), name_off.data(),
                 names.data(), ann_id.data(), ann_img.data(), ann_cat.data(),
                 ann_crowd.data(), ann_bbox.data(), ann_area.data(), cats.data());
    ld_coco_free(h);
  }
  printf("coco: %d/%d parsed\n", parsed, argc - 1);
  return 0;
}

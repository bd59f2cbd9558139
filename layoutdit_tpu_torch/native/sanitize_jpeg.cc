// Sanitizer harness for the port's native JPEG loader (loader.cc): the
// JPEG half of layoutdit_tpu/native/sanitize_main.cc, with the port's
// decode-only entries beside the JAX loader's. It is compiled together
// with loader.cc under ASan+UBSan (memory and undefined behaviour over a
// hostile corpus) and under TSan (the threaded batch entries) by
// tests/test_torch_sanitizers.py.
//
//   sanitize_jpeg resize <size> <file...>   ld_decode_resize_batch
//   sanitize_jpeg decode <file...>          ld_jpeg_dims + ld_decode_batch
//
// Exit 0 means no crash and no sanitizer report (the sanitizers abort
// with a nonzero code on a finding). Decode failures are fine: the
// corpus is mostly malformed on purpose.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
int ld_decode_resize_batch(const uint8_t** bufs, const long* lens, int n,
                           int out_size, float* out, float* orig_hw,
                           int n_threads);
int ld_jpeg_dims(const uint8_t* jpeg, long len, int* height, int* width);
int ld_decode_batch(const uint8_t** bufs, const long* lens, int n,
                    uint8_t** outs, const long* caps, int* hw, int n_threads);
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

struct Corpus {
  std::vector<std::string> blobs;
  std::vector<const uint8_t*> ptrs;
  std::vector<long> lens;

  Corpus(int n, char** paths) : blobs(n) {
    for (int i = 0; i < n; ++i) blobs[i] = read_file(paths[i]);
    for (const std::string& b : blobs) {
      ptrs.push_back(reinterpret_cast<const uint8_t*>(b.data()));
      lens.push_back(static_cast<long>(b.size()));
    }
  }
};

static int run_resize(int argc, char** argv) {
  const int size = atoi(argv[0]);
  const int n = argc - 1;
  Corpus c(n, argv + 1);
  std::vector<float> images(static_cast<size_t>(n) * 3 * size * size);
  std::vector<float> orig(static_cast<size_t>(n) * 2);
  const int fails = ld_decode_resize_batch(c.ptrs.data(), c.lens.data(), n,
                                           size, images.data(), orig.data(), 4);
  printf("resize: %d/%d failed\n", fails, n);
  return 0;
}

static int run_decode(int argc, char** argv) {
  const int n = argc;
  Corpus c(n, argv);
  // each buffer sized from the header, as the serving engine sizes it
  std::vector<std::vector<uint8_t>> pixels(n);
  std::vector<uint8_t*> outs(n);
  std::vector<long> caps(n);
  int headers = 0;
  for (int i = 0; i < n; ++i) {
    int h = 0, w = 0;
    if (ld_jpeg_dims(c.ptrs[i], c.lens[i], &h, &w) == 0) ++headers;
    pixels[i].resize(static_cast<size_t>(h) * w * 3 + 1);
    outs[i] = pixels[i].data();
    caps[i] = static_cast<long>(pixels[i].size() - 1);
  }
  std::vector<int> hw(static_cast<size_t>(n) * 2);
  const int fails = ld_decode_batch(c.ptrs.data(), c.lens.data(), n,
                                    outs.data(), caps.data(), hw.data(), 4);
  printf("decode: %d/%d headers, %d/%d failed\n", headers, n, fails, n);
  return 0;
}

int main(int argc, char** argv) {
  if (argc < 3) {
    fprintf(stderr, "usage: resize <size> <file...> | decode <file...>\n");
    return 2;
  }
  if (strcmp(argv[1], "resize") == 0) return run_resize(argc - 2, argv + 2);
  if (strcmp(argv[1], "decode") == 0) return run_decode(argc - 2, argv + 2);
  fprintf(stderr, "unknown mode %s\n", argv[1]);
  return 2;
}

/* Smoke test for the C ABI (libisle_trainer.so): drives the full
 * iterative-ingest training path from plain C via dlopen — the
 * reference's embedding scenario (drivers/trainer_export.cpp:31-99)
 * with no Python on the host side.
 *
 * Run:
 *   make -C native
 *   PYTHONPATH=<checkout>:<site-packages> JAX_PLATFORMS=cpu \
 *   ./native/capi_smoke ./native/libisle_trainer.so
 */
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>

typedef int64_t (*create_fn)(int32_t, int32_t, int64_t, int32_t, int32_t,
                             float);
typedef void (*feed_fn)(int64_t, int32_t, const int32_t*, const int32_t*,
                        int32_t);
typedef void (*void_fn)(int64_t);
typedef int32_t (*model_fn)(int64_t, float*);
typedef int32_t (*int_fn)(int64_t);

int main(int argc, char** argv) {
  const char* lib_path = argc > 1 ? argv[1] : "./libisle_trainer.so";
  void* lib = dlopen(lib_path, RTLD_NOW | RTLD_GLOBAL);
  if (!lib) {
    fprintf(stderr, "dlopen failed: %s\n", dlerror());
    return 1;
  }
  create_fn CreateTrainer = (create_fn)dlsym(lib, "CreateTrainer");
  feed_fn feedData = (feed_fn)dlsym(lib, "feedData");
  void_fn finalizeData = (void_fn)dlsym(lib, "finalizeData");
  void_fn Train = (void_fn)dlsym(lib, "Train");
  model_fn GetBasicModel = (model_fn)dlsym(lib, "GetBasicModel");
  int_fn GetNumEdgeTopics = (int_fn)dlsym(lib, "GetNumEdgeTopics");
  void_fn DestroyTrainer = (void_fn)dlsym(lib, "DestroyTrainer");
  if (!CreateTrainer || !feedData || !finalizeData || !Train ||
      !GetBasicModel || !GetNumEdgeTopics || !DestroyTrainer) {
    fprintf(stderr, "missing symbol: %s\n", dlerror());
    return 1;
  }

  const int32_t V = 120, D = 150, K = 4;
  int64_t h = CreateTrainer(V, D, 0, K, 0, 0.0f);
  if (h == 0) {
    fprintf(stderr, "CreateTrainer failed\n");
    return 1;
  }

  /* Deterministic synthetic corpus: 4 planted word bands + noise. */
  unsigned rng = 12345;
  for (int32_t d = 0; d < D; ++d) {
    int32_t words[16], counts[16];
    int32_t band = d % K, n = 0;
    for (int i = 0; i < 10; ++i) {
      rng = rng * 1103515245u + 12345u;
      words[n] = 1 + band * (V / K) + (int32_t)(rng % (uint32_t)(V / K));
      counts[n] = 1 + (int32_t)(rng % 5u);
      ++n;
    }
    for (int i = 0; i < 3; ++i) {
      rng = rng * 1103515245u + 12345u;
      words[n] = 1 + (int32_t)(rng % (uint32_t)V);
      counts[n] = 1;
      ++n;
    }
    feedData(h, d, words, counts, n);
  }
  finalizeData(h);
  Train(h);

  float* model = (float*)malloc(sizeof(float) * (size_t)V * (size_t)K);
  if (GetBasicModel(h, model) != 0) {
    fprintf(stderr, "GetBasicModel failed\n");
    return 1;
  }
  /* Every topic column must be an l1-normalized distribution (or empty). */
  int bad = 0, nonempty = 0;
  for (int t = 0; t < K; ++t) {
    double s = 0.0;
    for (int w = 0; w < V; ++w) {
      float x = model[t * V + w];
      if (!(x >= 0.0f) || x != x) bad = 1;
      s += x;
    }
    if (s > 0.5) {
      ++nonempty;
      if (fabs(s - 1.0) > 1e-3) bad = 1;
    }
  }
  int32_t edges = GetNumEdgeTopics(h);
  DestroyTrainer(h);
  free(model);
  if (bad || nonempty == 0) {
    fprintf(stderr, "model validation failed (bad=%d nonempty=%d)\n", bad,
            nonempty);
    return 1;
  }
  printf("CAPI SMOKE OK: %d topics trained, %d non-empty, %d edge topics\n",
         K, nonempty, edges);
  return 0;
}

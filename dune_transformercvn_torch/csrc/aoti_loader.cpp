// C++ loader of the port's AOTInductor serving packages, on libtorch: the
// counterpart of the JAX package's native/pjrt_loader.cc.
//
// Where pjrt_loader.cc hands an exported StableHLO graph to a PJRT plugin,
// which compiles it before the first call, this program loads a package
// that AOTInductor compiled ahead of time (dune_transformercvn_torch/aoti.py)
// with torch::inductor::AOTIModelPackageLoader and runs it once an event.
//
// With --graph the package's run is captured once into a CUDA graph and
// every event is one replay of it: one dispatch an event, as the JAX
// package's loader runs one PJRT Execute of a compiled rung.
//
// Build:   dune_transformercvn_torch.utils.build.build_loader() (g++ against
//          the installed torch's headers and libraries; with a CUDA build of
//          torch, against the CUDA headers too, TCVN_LOADER_CUDA)
// Run:     aoti_loader <model> <meta.json> <pixels.bin> <num_prongs> <out.bin>
//              [--device cuda|cpu] [--repeat N] [--graph] [--dry_run]
//
//   model       either an explicit `*.aoti.pt2` package (its prong capacity
//               is the package's "prong_capacity" metadata), or a variant
//               prefix like `/dir/transformercvn_pid`: the loader then picks
//               a packaged prong-capacity rung P >= num_prongs from the
//               meta's "aoti_prong_buckets" (the cheapest per the meta's
//               measured "aoti_bucket_ms" when every eligible rung has a
//               cost, ties to the smaller capacity; else the smallest; an
//               over-full event takes the largest rung: export.py's
//               select_bucket; with --graph by "aoti_graph_bucket_ms" when
//               every eligible rung has one, else as without it) and loads
//               `<prefix>_pP.aoti.pt2` (the full capacity keeps the
//               unsuffixed name)
//   meta.json   the `<prefix>_export_meta.json` written by export.py and
//               extended by aoti.py
//   pixels.bin  raw float32 [1 + max_prongs, C, H, W] counts (event map
//               first, prong maps padded to max_prongs rows); the loader
//               feeds only the first 1+P rows
//   num_prongs  real prong count (the graph masks rows past it)
//   out.bin     u32 output count, then each output as u32 rank, i64
//               dims[rank], u32 dtype (pjrt_c_api.h's PJRT_Buffer_Type
//               codes, as pjrt_loader.cc writes them), raw little-endian
//               bytes
//   --device    the device the package was compiled for (default cuda);
//               a package compiled for the other one is an error
//   --repeat N  run N more times after the first and report the mean time
//               of one run on stderr (the outputs written are the last run's)
//   --graph     on the card: allocate the static inputs there, run the
//               package once on a pool stream to warm it up, capture that
//               run into a CUDA graph (the package loaded single-threaded,
//               launching on the capturing stream), then copy the event in
//               and replay for the first run and each repeat; the outputs
//               written are the last replay's.  stderr adds the capture's
//               seconds.  Not on the CPU (exit 2)
//   --dry_run   read the meta, report the rung the event takes, and exit 0
//               without loading or running anything (no device needed)
//
// Exit 0 on success; 1 when loading, capturing or running fails, 2 on bad
// arguments or inputs, each with a message on stderr.  Nothing is retried
// on another device, and nothing asked to run as a graph runs uncaptured.

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <fstream>
#include <iterator>
#include <map>
#include <string>
#include <vector>

#include <ATen/ATen.h>
#include <c10/core/StreamGuard.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>
#include <torch/cuda.h>
#ifdef TCVN_LOADER_CUDA
#include <ATen/cuda/CUDAGraph.h>
#include <c10/cuda/CUDAStream.h>
#endif

namespace {

bool ReadFile(const std::string& path, std::string* out) {
  std::ifstream file(path, std::ios::binary);
  if (!file) return false;
  out->assign(std::istreambuf_iterator<char>(file), {});
  return true;
}

// "key": [a, b, ...] of the export meta, whose fixed layout the exporter
// writes (no general JSON parser needed).
std::vector<int64_t> ParseIntArray(const std::string& json, const std::string& key_name) {
  std::vector<int64_t> values;
  size_t key = json.find("\"" + key_name + "\"");
  if (key == std::string::npos) return values;
  size_t open = json.find('[', key);
  size_t close = json.find(']', open);
  if (open == std::string::npos || close == std::string::npos) return values;
  const char* p = json.c_str() + open + 1;
  const char* end = json.c_str() + close;
  while (p < end) {
    char* next = nullptr;
    long long v = std::strtoll(p, &next, 10);
    if (next == p) { ++p; continue; }
    values.push_back(v);
    p = next;
  }
  return values;
}

// "key": "value" of the export meta; "" when absent.
std::string ParseString(const std::string& json, const std::string& key_name) {
  size_t key = json.find("\"" + key_name + "\"");
  if (key == std::string::npos) return "";
  size_t colon = json.find(':', key);
  size_t q1 = json.find('"', colon);
  size_t q2 = json.find('"', q1 + 1);
  if (colon == std::string::npos || q1 == std::string::npos || q2 == std::string::npos)
    return "";
  return json.substr(q1 + 1, q2 - q1 - 1);
}

// "<key_name>": {"4": 1.55, "20": 5.07}: each packaged rung's measured
// per-event ms (aoti.py's bench: "aoti_bucket_ms", "aoti_graph_bucket_ms").
std::map<int64_t, double> ParseBucketCosts(const std::string& json,
                                           const std::string& key_name) {
  std::map<int64_t, double> costs;
  size_t key = json.find("\"" + key_name + "\"");
  if (key == std::string::npos) return costs;
  size_t open = json.find('{', key);
  size_t close = json.find('}', open);
  if (open == std::string::npos || close == std::string::npos) return costs;
  size_t p = open + 1;
  while (p < close) {
    size_t q1 = json.find('"', p);
    if (q1 == std::string::npos || q1 >= close) break;
    size_t q2 = json.find('"', q1 + 1);
    if (q2 == std::string::npos || q2 >= close) break;
    size_t colon = json.find(':', q2);
    if (colon == std::string::npos || colon >= close) break;
    const long long bucket = std::strtoll(json.c_str() + q1 + 1, nullptr, 10);
    costs[bucket] = std::strtod(json.c_str() + colon + 1, nullptr);
    size_t comma = json.find(',', colon);
    p = (comma == std::string::npos || comma > close) ? close : comma + 1;
  }
  return costs;
}

bool EndsWith(const std::string& s, const std::string& suffix) {
  return s.size() >= suffix.size() &&
         s.compare(s.size() - suffix.size(), suffix.size(), suffix) == 0;
}

// pjrt_c_api.h's PJRT_Buffer_Type codes; 0 (INVALID) for a dtype with none.
uint32_t PjrtType(at::ScalarType t) {
  switch (t) {
    case at::kBool: return 1;
    case at::kChar: return 2;
    case at::kShort: return 3;
    case at::kInt: return 4;
    case at::kLong: return 5;
    case at::kByte: return 6;
    case at::kHalf: return 10;
    case at::kFloat: return 11;
    case at::kDouble: return 12;
    case at::kBFloat16: return 13;
    default: return 0;
  }
}

double Seconds(std::chrono::steady_clock::time_point since) {
  return std::chrono::duration<double>(std::chrono::steady_clock::now() - since).count();
}

int Run(int argc, char** argv) {
  if (argc < 6) {
    std::fprintf(stderr,
                 "usage: %s <model.aoti.pt2 | variant prefix> <meta.json> <pixels.bin> "
                 "<num_prongs> <out.bin> [--device cuda|cpu] [--repeat N] [--graph] "
                 "[--dry_run]\n",
                 argv[0]);
    return 2;
  }
  const std::string model_spec = argv[1];
  const std::string meta_path = argv[2];
  const std::string pixels_path = argv[3];
  const int32_t num_prongs = static_cast<int32_t>(std::atoi(argv[4]));
  const std::string out_path = argv[5];
  std::string device_name = "cuda";
  int repeat = 0;
  bool graph = false;
  bool dry_run = false;
  for (int i = 6; i < argc; ++i) {
    const std::string arg = argv[i];
    if (arg == "--device" && i + 1 < argc) {
      device_name = argv[++i];
    } else if (arg == "--repeat" && i + 1 < argc) {
      repeat = std::atoi(argv[++i]);
    } else if (arg == "--graph") {
      graph = true;
    } else if (arg == "--dry_run") {
      dry_run = true;
    } else {
      std::fprintf(stderr, "unknown argument %s\n", arg.c_str());
      return 2;
    }
  }
  if (device_name != "cuda" && device_name != "cpu") {
    std::fprintf(stderr, "--device must be cuda or cpu, not %s\n", device_name.c_str());
    return 2;
  }
  if (graph && device_name != "cuda") {
    std::fprintf(stderr, "--graph captures a CUDA graph: it needs --device cuda and a "
                         "package compiled for the card (a CPU package runs without it)\n");
    return 2;
  }
  if (!dry_run && device_name == "cuda" && !torch::cuda::is_available()) {
    std::fprintf(stderr, "CUDA is not available to this loader; pass --device cpu "
                         "for a package compiled for the CPU\n");
    return 1;
  }
  const at::Device device(device_name == "cuda" ? at::kCUDA : at::kCPU, 0);

  std::string meta;
  if (!ReadFile(meta_path, &meta)) {
    std::fprintf(stderr, "cannot read %s\n", meta_path.c_str());
    return 2;
  }
  std::vector<int64_t> pixel_dims = ParseIntArray(meta, "input_shape");
  if (pixel_dims.size() != 4) {
    std::fprintf(stderr, "no 4-d \"input_shape\" in %s\n", meta_path.c_str());
    return 2;
  }
  const std::string platform = ParseString(meta, "aoti_platform");
  if (platform != device_name) {
    std::fprintf(stderr, "%s records packages for \"%s\", not for %s\n", meta_path.c_str(),
                 platform.c_str(), device_name.c_str());
    return 2;
  }
  const int64_t max_prongs = pixel_dims[0] - 1;

  // ---- the package: explicit, or a rung chosen for num_prongs -----------
  std::string package_path = model_spec;
  int64_t capacity = -1;
  if (!EndsWith(model_spec, ".aoti.pt2")) {
    const std::vector<int64_t> buckets = ParseIntArray(meta, "aoti_prong_buckets");
    if (buckets.empty()) {
      std::fprintf(stderr, "no \"aoti_prong_buckets\" in %s\n", meta_path.c_str());
      return 2;
    }
    int64_t largest = buckets[0];
    std::vector<int64_t> eligible;
    for (int64_t b : buckets) {
      if (b > largest) largest = b;
      if (b >= num_prongs) eligible.push_back(b);
    }
    if (eligible.empty()) eligible.push_back(largest);
    // the costs of the dispatch this run uses: the captured rungs' with
    // --graph when every eligible rung has one, else the uncaptured ones'
    auto covers = [&eligible](const std::map<int64_t, double>& c) {
      if (c.empty()) return false;
      for (int64_t b : eligible)
        if (c.find(b) == c.end()) return false;
      return true;
    };
    std::map<int64_t, double> costs;
    std::string cost_key = "aoti_bucket_ms";
    if (graph) {
      costs = ParseBucketCosts(meta, "aoti_graph_bucket_ms");
      cost_key = "aoti_graph_bucket_ms";
    }
    if (!covers(costs)) {
      costs = ParseBucketCosts(meta, "aoti_bucket_ms");
      cost_key = "aoti_bucket_ms";
    }
    const bool cost_aware = covers(costs);
    int64_t chosen = eligible[0];
    for (int64_t b : eligible) {
      if (cost_aware ? (costs.at(b) < costs.at(chosen) ||
                        (costs.at(b) == costs.at(chosen) && b < chosen))
                     : (b < chosen))
        chosen = b;
    }
    package_path = model_spec +
                   (chosen == max_prongs ? std::string("") : "_p" + std::to_string(chosen)) +
                   ".aoti.pt2";
    capacity = chosen;
    if (cost_aware && cost_key == "aoti_graph_bucket_ms")
      std::fprintf(stderr, "num_prongs %d -> bucket %lld [graph cost-aware %.3f ms] (%s)\n",
                   num_prongs, static_cast<long long>(chosen), costs.at(chosen),
                   package_path.c_str());
    else if (cost_aware)
      std::fprintf(stderr, "num_prongs %d -> bucket %lld [cost-aware %.3f ms] (%s)\n",
                   num_prongs, static_cast<long long>(chosen), costs.at(chosen),
                   package_path.c_str());
    else
      std::fprintf(stderr, "num_prongs %d -> bucket %lld (%s)\n", num_prongs,
                   static_cast<long long>(chosen), package_path.c_str());
  }

  if (dry_run) return 0;

  const auto t_load = std::chrono::steady_clock::now();
  // single-threaded for a graph: the default run records and waits on CUDA
  // events around each call, which a capture cannot hold
  torch::inductor::AOTIModelPackageLoader loader(package_path, "model", graph);
  if (capacity < 0) {
    const auto metadata = loader.get_metadata();
    const auto found = metadata.find("prong_capacity");
    if (found == metadata.end()) {
      std::fprintf(stderr, "%s carries no prong_capacity metadata\n", package_path.c_str());
      return 2;
    }
    capacity = std::strtoll(found->second.c_str(), nullptr, 10);
  }
  std::fprintf(stderr, "loaded %s on %s in %.3f s\n", package_path.c_str(),
               device_name.c_str(), Seconds(t_load));

  // ---- inputs: the first 1+P rows of the padded pixel maps --------------
  std::string pixels;
  if (!ReadFile(pixels_path, &pixels)) {
    std::fprintf(stderr, "cannot read %s\n", pixels_path.c_str());
    return 2;
  }
  pixel_dims[0] = 1 + capacity;
  int64_t count = 1;
  for (int64_t d : pixel_dims) count *= d;
  if (pixels.size() < static_cast<size_t>(count) * sizeof(float)) {
    std::fprintf(stderr, "%s holds %zu bytes, input shape wants %lld floats\n",
                 pixels_path.c_str(), pixels.size(), static_cast<long long>(count));
    return 2;
  }
  at::Tensor host = at::from_blob(pixels.data(), pixel_dims, at::kFloat);
  std::vector<at::Tensor> inputs = {
      host.to(device),
      at::scalar_tensor(num_prongs, at::TensorOptions().dtype(at::kInt)).to(device)};

  // ---- run ---------------------------------------------------------------
  std::vector<at::Tensor> outputs;
  if (graph) {
#ifdef TCVN_LOADER_CUDA
    // static inputs on the card; the warm-up and the capture on a pool
    // stream (a capture cannot use the default stream), the package told to
    // launch on it
    std::vector<at::Tensor> statics = {at::empty_like(inputs[0]),
                                       at::empty_like(inputs[1])};
    const c10::cuda::CUDAStream stream = c10::cuda::getStreamFromPool(false, device.index());
    c10::StreamGuard on_stream(stream.unwrap());
    void* handle = reinterpret_cast<void*>(stream.stream());
    for (size_t i = 0; i < statics.size(); ++i) statics[i].copy_(inputs[i]);
    const auto t_capture = std::chrono::steady_clock::now();
    loader.run(statics, handle);
    torch::cuda::synchronize();
    at::cuda::CUDAGraph cuda_graph;
    cuda_graph.capture_begin(at::cuda::graph_pool_handle(), cudaStreamCaptureModeThreadLocal);
    try {
      outputs = loader.run(statics, handle);
    } catch (...) {
      try { cuda_graph.capture_end(); } catch (...) {}
      throw;
    }
    cuda_graph.capture_end();
    torch::cuda::synchronize();
    std::fprintf(stderr, "captured in %.3f s (warm-up run and capture)\n",
                 Seconds(t_capture));
    // every run, the first too: the event in, one replay
    auto replay = [&]() {
      for (size_t i = 0; i < statics.size(); ++i) statics[i].copy_(inputs[i], true);
      cuda_graph.replay();
    };
    const auto t_first = std::chrono::steady_clock::now();
    replay();
    torch::cuda::synchronize();
    std::fprintf(stderr, "first run: %.4f ms (one replay)\n", 1e3 * Seconds(t_first));
    if (repeat > 0) {
      const auto t_run = std::chrono::steady_clock::now();
      for (int i = 0; i < repeat; ++i) replay();
      torch::cuda::synchronize();
      std::fprintf(stderr, "run: %.4f ms (mean of %d replays after the first)\n",
                   1e3 * Seconds(t_run) / repeat, repeat);
    }
    for (auto& out : outputs) out = out.clone();
    torch::cuda::synchronize();
#else
    std::fprintf(stderr, "this loader was built without CUDA (a CPU build of torch); "
                         "--graph needs one built against a CUDA build\n");
    return 1;
#endif
  } else {
    const auto t_first = std::chrono::steady_clock::now();
    outputs = loader.run(inputs);
    if (device.is_cuda()) torch::cuda::synchronize();
    std::fprintf(stderr, "first run: %.4f ms\n", 1e3 * Seconds(t_first));
    if (repeat > 0) {
      const auto t_run = std::chrono::steady_clock::now();
      for (int i = 0; i < repeat; ++i) outputs = loader.run(inputs);
      if (device.is_cuda()) torch::cuda::synchronize();
      std::fprintf(stderr, "run: %.4f ms (mean of %d after the first)\n",
                   1e3 * Seconds(t_run) / repeat, repeat);
    }
  }

  // ---- every output to out.bin -----------------------------------------
  std::ofstream out(out_path, std::ios::binary);
  const uint32_t n_out = static_cast<uint32_t>(outputs.size());
  out.write(reinterpret_cast<const char*>(&n_out), sizeof(n_out));
  for (size_t i = 0; i < outputs.size(); ++i) {
    const at::Tensor value = outputs[i].to(at::kCPU).contiguous();
    const uint32_t dtype = PjrtType(value.scalar_type());
    if (dtype == 0) {
      std::fprintf(stderr, "output %zu has dtype %s, which has no PJRT code\n", i,
                   c10::toString(value.scalar_type()));
      return 1;
    }
    const uint32_t rank = static_cast<uint32_t>(value.dim());
    const std::vector<int64_t> dims(value.sizes().begin(), value.sizes().end());
    out.write(reinterpret_cast<const char*>(&rank), sizeof(rank));
    out.write(reinterpret_cast<const char*>(dims.data()), sizeof(int64_t) * rank);
    out.write(reinterpret_cast<const char*>(&dtype), sizeof(dtype));
    out.write(static_cast<const char*>(value.data_ptr()),
              static_cast<std::streamsize>(value.nbytes()));
  }
  out.close();
  if (!out) {
    std::fprintf(stderr, "cannot write %s\n", out_path.c_str());
    return 1;
  }
  std::printf("wrote %zu outputs to %s\n", outputs.size(), out_path.c_str());
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  try {
    return Run(argc, argv);
  } catch (const std::exception& e) {
    std::fprintf(stderr, "aoti_loader failed: %s\n", e.what());
    return 1;
  }
}

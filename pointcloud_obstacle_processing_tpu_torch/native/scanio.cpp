// scanio — native host runtime for the obstacle pipeline (a copy of the
// reference package's native/scanio.cpp; the port keeps its own).
//
// The reference node's host-side hot path is the ROS message <-> PCL
// container conversion plus the frame accumulator
// (obstacle_detection.cpp:682-698; the author marks the conversions
// "MASSIVELY SLOW", :721).  This library is the host runtime's native
// equivalent: it decodes PointCloud2-style strided binary scans straight
// into the padded [capacity, 3] float32 buffer the device consumes,
// applies the sensor->world rigid transform on the fly (the
// pcl_ros::transformPointCloud of cpp:696), maintains the accumulation
// window (cpp:78, :697-698), and fills the validity mask — one pass,
// multithreaded, no intermediate containers.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Accumulator {
  float* points;      // [capacity, 3] caller-owned or self-owned
  uint8_t* valid;     // [capacity]
  int64_t capacity;
  std::atomic<int64_t> count;
  bool owns;
};

inline void transform_point(const float* R, const float* t, const float* in,
                            float* out) {
  const float x = in[0], y = in[1], z = in[2];
  out[0] = R[0] * x + R[1] * y + R[2] * z + t[0];
  out[1] = R[3] * x + R[4] * y + R[5] * z + t[1];
  out[2] = R[6] * x + R[7] * y + R[8] * z + t[2];
}

int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n ? static_cast<int>(n) : 4;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- lifetime
void* accumulator_create(int64_t capacity) {
  auto* acc = new Accumulator();
  acc->points = new float[capacity * 3]();
  acc->valid = new uint8_t[capacity]();
  acc->capacity = capacity;
  acc->count.store(0);
  acc->owns = true;
  return acc;
}

void accumulator_destroy(void* handle) {
  auto* acc = static_cast<Accumulator*>(handle);
  if (acc->owns) {
    delete[] acc->points;
    delete[] acc->valid;
  }
  delete acc;
}

void accumulator_clear(void* handle) {
  auto* acc = static_cast<Accumulator*>(handle);
  // mask-only clear: stale points are ignored via the validity mask
  std::memset(acc->valid, 0, acc->capacity);
  acc->count.store(0);
}

int64_t accumulator_count(void* handle) {
  return static_cast<Accumulator*>(handle)->count.load();
}

int64_t accumulator_capacity(void* handle) {
  return static_cast<Accumulator*>(handle)->capacity;
}

void accumulator_snapshot(void* handle, float* points_out, uint8_t* valid_out) {
  auto* acc = static_cast<Accumulator*>(handle);
  std::memcpy(points_out, acc->points, acc->capacity * 3 * sizeof(float));
  std::memcpy(valid_out, acc->valid, acc->capacity);
}

// ------------------------------------------------------------- scan decode
// Decode a PointCloud2-style blob: `n_points` records of `point_step`
// bytes, float32 x/y/z at byte offsets off_x/off_y/off_z.  Each finite
// point is transformed by (R[9] row-major, t[3]) and appended to the
// accumulator.  Non-finite points are skipped (the reference's NaN
// rejection happens later in its pipeline, cpp:197; dropping them here
// only removes padding work — the crop stage re-checks).
// Returns the number of points appended (capacity-clamped).
int64_t accumulator_append_cloud2(void* handle, const uint8_t* data,
                                  int64_t n_points, int32_t point_step,
                                  int32_t off_x, int32_t off_y, int32_t off_z,
                                  const float* R, const float* t,
                                  int32_t n_threads) {
  auto* acc = static_cast<Accumulator*>(handle);
  const int64_t start = acc->count.load();
  if (start >= acc->capacity || n_points <= 0) return 0;

  // First pass: decode+transform into a scratch area sized n_points, with a
  // per-thread compaction, then a serial stitch into the accumulator.
  int nt = n_threads > 0 ? n_threads : hw_threads();
  if (n_points < 8192) nt = 1;
  std::vector<std::vector<float>> parts(nt);
  std::vector<std::thread> threads;
  const int64_t chunk = (n_points + nt - 1) / nt;

  for (int ti = 0; ti < nt; ++ti) {
    threads.emplace_back([&, ti]() {
      const int64_t lo = ti * chunk;
      const int64_t hi = std::min<int64_t>(n_points, lo + chunk);
      auto& out = parts[ti];
      out.reserve((hi > lo ? hi - lo : 0) * 3);
      float p[3], q[3];
      for (int64_t i = lo; i < hi; ++i) {
        const uint8_t* rec = data + i * point_step;
        std::memcpy(&p[0], rec + off_x, 4);
        std::memcpy(&p[1], rec + off_y, 4);
        std::memcpy(&p[2], rec + off_z, 4);
        if (!std::isfinite(p[0]) || !std::isfinite(p[1]) ||
            !std::isfinite(p[2]))
          continue;
        transform_point(R, t, p, q);
        out.push_back(q[0]);
        out.push_back(q[1]);
        out.push_back(q[2]);
      }
    });
  }
  for (auto& th : threads) th.join();

  int64_t cursor = start;
  for (auto& part : parts) {
    const int64_t n = static_cast<int64_t>(part.size() / 3);
    const int64_t room = acc->capacity - cursor;
    const int64_t take = std::min(n, room);
    if (take > 0) {
      std::memcpy(acc->points + cursor * 3, part.data(),
                  take * 3 * sizeof(float));
      std::memset(acc->valid + cursor, 1, take);
      cursor += take;
    }
  }
  acc->count.store(cursor);
  return cursor - start;
}

// Append an already-decoded [n, 3] float32 array (e.g. replayed frames).
int64_t accumulator_append_xyz(void* handle, const float* xyz, int64_t n,
                               const float* R, const float* t) {
  auto* acc = static_cast<Accumulator*>(handle);
  const int64_t start = acc->count.load();
  int64_t cursor = start;
  for (int64_t i = 0; i < n && cursor < acc->capacity; ++i) {
    float q[3];
    transform_point(R, t, xyz + i * 3, q);
    if (!std::isfinite(q[0]) || !std::isfinite(q[1]) || !std::isfinite(q[2]))
      continue;
    std::memcpy(acc->points + cursor * 3, q, 12);
    acc->valid[cursor] = 1;
    ++cursor;
  }
  acc->count.store(cursor);
  return cursor - start;
}

// Standalone decode (no accumulation): blob -> packed xyz + valid mask.
// Returns number of finite points written (<= max_out).
int64_t decode_cloud2(const uint8_t* data, int64_t n_points,
                      int32_t point_step, int32_t off_x, int32_t off_y,
                      int32_t off_z, float* xyz_out, int64_t max_out) {
  int64_t w = 0;
  float p[3];
  for (int64_t i = 0; i < n_points && w < max_out; ++i) {
    const uint8_t* rec = data + i * point_step;
    std::memcpy(&p[0], rec + off_x, 4);
    std::memcpy(&p[1], rec + off_y, 4);
    std::memcpy(&p[2], rec + off_z, 4);
    if (!std::isfinite(p[0]) || !std::isfinite(p[1]) || !std::isfinite(p[2]))
      continue;
    std::memcpy(xyz_out + w * 3, p, 12);
    ++w;
  }
  return w;
}

// --------------------------------------------- organized-cloud (v2) decode
// Full sensor_msgs/PointCloud2 layout: `height` rows of `width` records,
// rows `row_step` bytes apart (row padding allowed: row_step >=
// width*point_step), records `point_step` bytes apart.  `data_len` bounds
// every read IN native code (defense in depth on top of the Python-side
// layout validation): a record is decoded only if it fits entirely inside
// the buffer, so truncated streams degrade to fewer points, never OOB
// reads.  Reference layout fields: obstacle_detection.cpp:80 (960x540 qhd
// organized input), CMakeLists.txt:60-85 message surface.
int64_t decode_cloud2_rows(const uint8_t* data, int64_t data_len,
                           int32_t height, int32_t width, int64_t row_step,
                           int32_t point_step, int32_t off_x, int32_t off_y,
                           int32_t off_z, float* xyz_out, int64_t max_out) {
  if (point_step <= 0 || row_step < 0 || height < 0 || width < 0) return 0;
  if (off_x < 0 || off_y < 0 || off_z < 0) return 0;
  if (off_x + 4 > point_step || off_y + 4 > point_step ||
      off_z + 4 > point_step)
    return 0;
  int64_t w = 0;
  float p[3];
  for (int64_t r = 0; r < height && w < max_out; ++r) {
    const int64_t row_base = r * row_step;
    for (int64_t c = 0; c < width && w < max_out; ++c) {
      const int64_t rec_off = row_base + c * point_step;
      if (rec_off + point_step > data_len) break;  // truncated tail
      const uint8_t* rec = data + rec_off;
      std::memcpy(&p[0], rec + off_x, 4);
      std::memcpy(&p[1], rec + off_y, 4);
      std::memcpy(&p[2], rec + off_z, 4);
      if (!std::isfinite(p[0]) || !std::isfinite(p[1]) ||
          !std::isfinite(p[2]))
        continue;
      std::memcpy(xyz_out + w * 3, p, 12);
      ++w;
    }
  }
  return w;
}

// Organized-cloud accumulate: decode_cloud2_rows + transform + append,
// multithreaded over rows.  Same in-ABI bounds guarantees as above.
int64_t accumulator_append_cloud2_rows(void* handle, const uint8_t* data,
                                       int64_t data_len, int32_t height,
                                       int32_t width, int64_t row_step,
                                       int32_t point_step, int32_t off_x,
                                       int32_t off_y, int32_t off_z,
                                       const float* R, const float* t,
                                       int32_t n_threads) {
  auto* acc = static_cast<Accumulator*>(handle);
  const int64_t start = acc->count.load();
  if (start >= acc->capacity || height <= 0 || width <= 0) return 0;
  if (point_step <= 0 || row_step < 0) return 0;
  if (off_x < 0 || off_y < 0 || off_z < 0) return 0;
  if (off_x + 4 > point_step || off_y + 4 > point_step ||
      off_z + 4 > point_step)
    return 0;

  int nt = n_threads > 0 ? n_threads : hw_threads();
  if (static_cast<int64_t>(height) * width < 8192) nt = 1;
  if (nt > height) nt = height;
  std::vector<std::vector<float>> parts(nt);
  std::vector<std::thread> threads;
  const int64_t rows_per = (height + nt - 1) / nt;

  for (int ti = 0; ti < nt; ++ti) {
    threads.emplace_back([&, ti]() {
      const int64_t r_lo = ti * rows_per;
      const int64_t r_hi = std::min<int64_t>(height, r_lo + rows_per);
      auto& out = parts[ti];
      out.reserve((r_hi > r_lo ? (r_hi - r_lo) * width : 0) * 3);
      float p[3], q[3];
      for (int64_t r = r_lo; r < r_hi; ++r) {
        const int64_t row_base = r * row_step;
        for (int64_t c = 0; c < width; ++c) {
          const int64_t rec_off = row_base + c * point_step;
          if (rec_off + point_step > data_len) break;
          const uint8_t* rec = data + rec_off;
          std::memcpy(&p[0], rec + off_x, 4);
          std::memcpy(&p[1], rec + off_y, 4);
          std::memcpy(&p[2], rec + off_z, 4);
          if (!std::isfinite(p[0]) || !std::isfinite(p[1]) ||
              !std::isfinite(p[2]))
            continue;
          transform_point(R, t, p, q);
          out.push_back(q[0]);
          out.push_back(q[1]);
          out.push_back(q[2]);
        }
      }
    });
  }
  for (auto& th : threads) th.join();

  int64_t cursor = start;
  for (auto& part : parts) {
    const int64_t n = static_cast<int64_t>(part.size() / 3);
    const int64_t room = acc->capacity - cursor;
    const int64_t take = std::min(n, room);
    if (take > 0) {
      std::memcpy(acc->points + cursor * 3, part.data(),
                  take * 3 * sizeof(float));
      std::memset(acc->valid + cursor, 1, take);
      cursor += take;
    }
  }
  acc->count.store(cursor);
  return cursor - start;
}

}  // extern "C"

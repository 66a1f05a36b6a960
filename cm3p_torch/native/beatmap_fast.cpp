// Native .osu -> event-group -> token-id front end.
//
// C++ re-implementation of the host data-pipeline hot path:
//   cm3p_torch/beatmap/osu.py     (.osu text parsing)
//   cm3p_torch/beatmap/curves.py  (slider curve geometry, arc-length eval)
//   cm3p_torch/beatmap/parser.py  (event lowering, timing grid, kiai, mania SV)
//   cm3p_torch/beatmap/events.py  (merge/speed/median-mpb stream utilities)
//   cm3p_torch/tokenize/beatmap_tokenizer.py (window serialization to vocab ids)
//
// The Python path stays the source of truth: tests/test_torch_native.py
// asserts bit-identical token ids on every fixture x parser config x speed,
// and the processor falls back to the Python path on any input this file
// reports it does not cover.
//
// Vocab ids are never computed here: Python pre-builds dense lookup tables
// (one per token family, indexed by the quantized value) from its vocab dict,
// so the quantization arithmetic below is the only contract this file owns.
// All float arithmetic replicates the numpy/python ops order; rounding uses
// rint (round-half-even, matching python round()/np.round).
//
// Build: cm3p_torch/native/__init__.py (with -ffp-contract=off).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#if defined(_WIN32)
#define CT_EXPORT extern "C" __declspec(dllexport)
#else
#define CT_EXPORT extern "C" __attribute__((visibility("default")))
#endif

namespace {

// ----------------------------------------------------------------- numerics

// python round() / np.round: round-half-even.
static inline long long py_round(double x) { return (long long)std::rint(x); }
// python int() on float: truncate toward zero.
static inline long long py_int(double x) { return (long long)std::trunc(x); }

// ------------------------------------------------------------- osu! objects

struct TimingPoint {
  double offset = 0.0;
  double ms_per_beat = 0.0;
  int meter = 4;
  int sample_type = 0;
  int sample_index = 0;
  int volume = 100;
  bool kiai = false;
  int parent = -1;  // index of most recent uninherited point, -1 = none
  bool inherited() const { return ms_per_beat < 0.0; }
  bool has_bpm() const {
    return !inherited() && ms_per_beat != 0.0 && !std::isnan(ms_per_beat);
  }
};

enum HoKind { HO_CIRCLE, HO_SLIDER, HO_SPINNER, HO_HOLD };

struct HitObject {
  HoKind kind = HO_CIRCLE;
  double x = 0, y = 0;
  double time = 0;
  int hitsound = 0;
  std::string addition = "0:0:0:0:";
  bool new_combo = false;
  double end_time = 0;  // spinner/hold/slider
  // slider only:
  int repeat = 1;
  double pixel_length = 0;
  char curve_kind = 'B';
  std::vector<std::pair<double, double>> points;  // incl. head
  std::vector<int> edge_sounds;
  std::vector<std::string> edge_additions;
};

struct BeatmapData {
  int format_version = 14;
  int mode = 0;
  double circle_size = 5.0;
  double slider_multiplier = 1.4;
  std::vector<TimingPoint> tps;
  std::vector<HitObject> hos;
  std::vector<double> tp_offsets;  // cache for bisect
  bool tp_sorted = true;
  bool parse_error = false;  // malformed content the python path would raise on
};

// --------------------------------------------------------------- text parse

static inline void trim(std::string& s) {
  size_t a = s.find_first_not_of(" \t\r\n");
  if (a == std::string::npos) { s.clear(); return; }
  size_t b = s.find_last_not_of(" \t\r\n");
  s = s.substr(a, b - a + 1);
}

// python float(): strict full-token parse (after strip). Returns false on
// failure. Accepts inf/nan like python; rejects trailing junk.
static bool py_float(const std::string& tok, double* out) {
  std::string t = tok;
  trim(t);
  if (t.empty()) return false;
  // python float() rejects hex literals that strtod accepts
  if (t.find('x') != std::string::npos || t.find('X') != std::string::npos)
    return false;
  const char* c = t.c_str();
  char* end = nullptr;
  double v = std::strtod(c, &end);
  if (end != c + t.size()) return false;
  *out = v;
  return true;
}

// python int(): strict decimal integer.
static bool py_strict_int(const std::string& tok, long long* out) {
  std::string t = tok;
  trim(t);
  if (t.empty()) return false;
  const char* c = t.c_str();
  char* end = nullptr;
  long long v = std::strtoll(c, &end, 10);
  if (end != c + t.size()) return false;
  *out = v;
  return true;
}

static void split(const std::string& s, char sep, std::vector<std::string>* out) {
  out->clear();
  size_t start = 0;
  while (true) {
    size_t p = s.find(sep, start);
    if (p == std::string::npos) { out->push_back(s.substr(start)); break; }
    out->push_back(s.substr(start, p - start));
    start = p + 1;
  }
}

static std::string lower(std::string s) {
  for (char& c : s) c = (char)std::tolower((unsigned char)c);
  return s;
}

// timing_point_at: last point with offset <= t (bisect when sorted, matching
// osu.py:131-149), falling back to tps[0].
static int timing_point_at(const BeatmapData& bm, double t) {
  if (bm.tps.empty()) return -1;
  if (bm.tp_sorted) {
    // bisect_right(offsets, t) - 1, clamped at 0
    auto it = std::upper_bound(bm.tp_offsets.begin(), bm.tp_offsets.end(), t);
    long idx = (long)(it - bm.tp_offsets.begin()) - 1;
    if (idx < 0) idx = 0;
    return (int)idx;
  }
  for (int i = (int)bm.tps.size() - 1; i >= 0; --i)
    if (bm.tps[i].offset <= t) return i;
  return 0;
}

static int uninherited_point_at(const BeatmapData& bm, double t) {
  int i = timing_point_at(bm, t);
  if (i < 0) return -1;
  return bm.tps[i].parent >= 0 ? bm.tps[i].parent : i;
}

static void parse_timing_line(BeatmapData* bm, const std::string& line,
                              int* last_uninherited) {
  std::vector<std::string> parts;
  split(line, ',', &parts);
  if (parts.size() < 2) return;
  double offset, msb;
  if (!py_float(parts[0], &offset) || !py_float(parts[1], &msb)) return;
  auto opt_int = [&](size_t i, long long dflt) -> long long {
    if (parts.size() > i && !parts[i].empty()) {
      double v;
      if (py_float(parts[i], &v)) return py_int(v);
      bm->parse_error = true;  // python int(float(x)) would raise
      return dflt;
    }
    return dflt;
  };
  TimingPoint tp;
  tp.offset = offset;
  tp.ms_per_beat = msb;
  tp.meter = (int)opt_int(2, 4);
  tp.sample_type = (int)opt_int(3, 0);
  tp.sample_index = (int)opt_int(4, 0);
  tp.volume = (int)opt_int(5, 100);
  long long effects = opt_int(7, 0);
  tp.kiai = (effects & 1) != 0;
  if (tp.inherited()) {
    tp.parent = *last_uninherited;
  } else {
    *last_uninherited = (int)bm->tps.size();
  }
  bm->tps.push_back(tp);
}

static const int TYPE_CIRCLE = 1, TYPE_SLIDER = 2, TYPE_NEW_COMBO = 4,
                 TYPE_SPINNER = 8, TYPE_HOLD = 128;

// slider velocity math: osu.py:342-359
static void slider_times(const BeatmapData& bm, double time, int repeat,
                         double pixel_length, double* end_time) {
  double sv = 1.0, ms_per_beat = 1000.0;
  if (!bm.tps.empty()) {
    int ti = timing_point_at(bm, time);
    const TimingPoint& tp = bm.tps[ti];
    if (tp.parent >= 0) {
      sv = -100.0 / tp.ms_per_beat;
      sv = std::min(std::max(sv, 0.01), 10.0);
      ms_per_beat = bm.tps[tp.parent].ms_per_beat;
    } else {
      sv = 1.0;
      ms_per_beat = tp.inherited() ? 1000.0 : tp.ms_per_beat;
    }
  }
  double ppb = bm.slider_multiplier * 100.0 * sv;
  double num_beats = ppb > 0.0 ? (pixel_length * (double)repeat) / ppb : 0.0;
  double duration = std::ceil(num_beats * ms_per_beat);
  *end_time = time + duration;
}

static void parse_hit_object_line(BeatmapData* bm, const std::string& line) {
  std::vector<std::string> parts;
  split(line, ',', &parts);
  if (parts.size() < 5) return;
  double x, y, time;
  long long type_bits, hitsound_ll;
  if (!py_float(parts[0], &x) || !py_float(parts[1], &y) ||
      !py_float(parts[2], &time) || !py_strict_int(parts[3], &type_bits) ||
      !py_strict_int(parts[4], &hitsound_ll))
    return;
  HitObject ho;
  ho.x = x; ho.y = y; ho.time = time;
  ho.hitsound = (int)hitsound_ll;
  ho.new_combo = (type_bits & TYPE_NEW_COMBO) != 0;

  if (type_bits & TYPE_CIRCLE) {
    ho.kind = HO_CIRCLE;
    if (parts.size() > 5 && parts[5].find(':') != std::string::npos)
      ho.addition = parts[5];
    bm->hos.push_back(std::move(ho));
    return;
  }
  if (type_bits & TYPE_SLIDER) {
    if (parts.size() < 6) return;
    ho.kind = HO_SLIDER;
    std::vector<std::string> spec;
    split(parts[5], '|', &spec);
    ho.curve_kind = spec.empty() || spec[0].empty() ? 'B' : spec[0][0];
    ho.points.emplace_back(x, y);
    for (size_t i = 1; i < spec.size(); ++i) {
      size_t p = spec[i].find(':');
      if (p == std::string::npos) continue;
      double px, py;
      if (!py_float(spec[i].substr(0, p), &px) ||
          !py_float(spec[i].substr(p + 1), &py)) {
        bm->parse_error = true;  // python float() would raise
        return;
      }
      ho.points.emplace_back(px, py);
    }
    ho.repeat = 1;
    if (parts.size() > 6 && !parts[6].empty()) {
      double r;
      if (py_float(parts[6], &r)) ho.repeat = (int)py_int(r);
      else { bm->parse_error = true; return; }
    }
    ho.repeat = std::max(ho.repeat, 1);
    ho.pixel_length = 0.0;
    if (parts.size() > 7 && !parts[7].empty()) {
      if (!py_float(parts[7], &ho.pixel_length)) { bm->parse_error = true; return; }
    }
    if (parts.size() > 8 && !parts[8].empty()) {
      std::vector<std::string> es;
      split(parts[8], '|', &es);
      std::vector<int> sounds;
      bool ok = true;
      for (const auto& s : es) {
        if (s.empty()) continue;
        double v;
        if (!py_float(s, &v)) { ok = false; break; }
        sounds.push_back((int)py_int(v));
      }
      if (ok) ho.edge_sounds = std::move(sounds);  // python: except -> []
    }
    if (parts.size() > 9 && !parts[9].empty()) {
      std::vector<std::string> ea;
      split(parts[9], '|', &ea);
      for (const auto& s : ea) {
        if (s.empty()) continue;
        ho.edge_additions.push_back(
            s.find(':') != std::string::npos ? s : std::string("0:0"));
      }
    }
    if (parts.size() > 10 && parts[10].find(':') != std::string::npos)
      ho.addition = parts[10];
    slider_times(*bm, time, ho.repeat, ho.pixel_length, &ho.end_time);
    bm->hos.push_back(std::move(ho));
    return;
  }
  if (type_bits & TYPE_SPINNER) {
    if (parts.size() < 6) return;
    ho.kind = HO_SPINNER;
    if (!py_float(parts[5], &ho.end_time)) { bm->parse_error = true; return; }
    if (parts.size() > 6 && parts[6].find(':') != std::string::npos)
      ho.addition = parts[6];
    bm->hos.push_back(std::move(ho));
    return;
  }
  if (type_bits & TYPE_HOLD) {
    if (parts.size() < 6) return;
    ho.kind = HO_HOLD;
    const std::string& tail = parts[5];
    size_t p = tail.find(':');
    std::string end_str = p == std::string::npos ? tail : tail.substr(0, p);
    std::string addition = p == std::string::npos ? "0:0:0:0:" : tail.substr(p + 1);
    if (addition.empty()) addition = "0:0:0:0:";
    if (!py_float(end_str, &ho.end_time)) { bm->parse_error = true; return; }
    ho.addition = addition;
    bm->hos.push_back(std::move(ho));
    return;
  }
}

static BeatmapData* parse_osu(const char* text, size_t len) {
  auto* bm = new BeatmapData();
  std::string section;
  std::vector<std::string> timing_lines, object_lines;
  size_t pos = 0;
  std::string line;
  while (pos <= len) {
    size_t nl = std::string::npos;
    for (size_t i = pos; i < len; ++i)
      if (text[i] == '\n' || text[i] == '\r') { nl = i; break; }
    if (nl == std::string::npos) {
      if (pos >= len) break;
      line.assign(text + pos, len - pos);
      pos = len + 1;
    } else {
      line.assign(text + pos, nl - pos);
      pos = nl + 1;
      // swallow \r\n pairs
      if (nl + 1 < len && text[nl] == '\r' && text[nl + 1] == '\n') pos = nl + 2;
    }
    trim(line);
    if (line.empty() || (line.size() >= 2 && line[0] == '/' && line[1] == '/'))
      continue;
    if (line.rfind("osu file format v", 0) == 0) {
      long long v;
      size_t vp = line.rfind('v');
      if (vp != std::string::npos && py_strict_int(line.substr(vp + 1), &v))
        bm->format_version = (int)v;
      continue;
    }
    if (line.front() == '[' && line.back() == ']') {
      section = lower(line.substr(1, line.size() - 2));
      continue;
    }
    if (section == "general" || section == "metadata" ||
        section == "difficulty" || section == "editor") {
      size_t c = line.find(':');
      if (c == std::string::npos) continue;
      std::string key = line.substr(0, c), value = line.substr(c + 1);
      trim(key); trim(value);
      double v;
      if (key == "Mode") {
        long long m;
        if (py_strict_int(value, &m)) bm->mode = (int)m; else bm->parse_error = true;
      } else if (key == "CircleSize") {
        if (py_float(value, &v)) bm->circle_size = v; else bm->parse_error = true;
      } else if (key == "SliderMultiplier") {
        if (py_float(value, &v)) bm->slider_multiplier = v; else bm->parse_error = true;
      }
      // other keys (title/artist/...) are irrelevant to the event stream
    } else if (section == "timingpoints") {
      timing_lines.push_back(line);
    } else if (section == "hitobjects") {
      object_lines.push_back(line);
    }
  }
  int last_uninherited = -1;
  for (const auto& l : timing_lines) parse_timing_line(bm, l, &last_uninherited);
  bm->tp_offsets.reserve(bm->tps.size());
  for (const auto& tp : bm->tps) bm->tp_offsets.push_back(tp.offset);
  bm->tp_sorted = std::is_sorted(bm->tp_offsets.begin(), bm->tp_offsets.end());
  for (const auto& l : object_lines) parse_hit_object_line(bm, l);
  return bm;
}

// ------------------------------------------------------------------- curves

// numpy.linspace(0, 1, n): step = 1/(n-1); y[i] = i*step; y[n-1] = 1 exactly.
static inline double linspace01(int i, int n, double step) {
  return i == n - 1 ? 1.0 : (double)i * step;
}

// curves.py:_bezier_points — vectorized de Casteljau, same op order.
static void bezier_points(const std::vector<std::pair<double, double>>& control,
                          int n, std::vector<std::pair<double, double>>* out) {
  int degree = (int)control.size() - 1;
  if (degree == 0) {
    for (int i = 0; i < n; ++i) out->push_back(control[0]);
    return;
  }
  double step = 1.0 / (double)(n - 1);
  std::vector<double> px(control.size()), py_(control.size());
  for (int i = 0; i < n; ++i) {
    double t = linspace01(i, n, step);
    double mt = 1.0 - t;
    for (size_t k = 0; k < control.size(); ++k) {
      px[k] = control[k].first;
      py_[k] = control[k].second;
    }
    int m = degree;
    while (m > 0) {
      for (int k = 0; k < m; ++k) {
        px[k] = px[k] * mt + px[k + 1] * t;
        py_[k] = py_[k] * mt + py_[k + 1] * t;
      }
      --m;
    }
    out->emplace_back(px[0], py_[0]);
  }
}

static const int SAMPLES_PER_SEGMENT = 64;

// curves.py:_catmull_points
static void catmull_points(const std::vector<std::pair<double, double>>& c,
                           std::vector<std::pair<double, double>>* out) {
  out->push_back(c[0]);
  int num = (int)c.size();
  int n_per_span = SAMPLES_PER_SEGMENT;
  double step = 1.0 / (double)(n_per_span - 1);
  for (int i = 0; i + 1 < num; ++i) {
    double p0x = i > 0 ? c[i - 1].first : c[0].first;
    double p0y = i > 0 ? c[i - 1].second : c[0].second;
    double p1x = c[i].first, p1y = c[i].second;
    double p2x = c[i + 1].first, p2y = c[i + 1].second;
    double p3x, p3y;
    if (i + 2 < num) { p3x = c[i + 2].first; p3y = c[i + 2].second; }
    else { p3x = 2.0 * c[i + 1].first - c[i].first; p3y = 2.0 * c[i + 1].second - c[i].second; }
    for (int k = 1; k < n_per_span; ++k) {
      double t = linspace01(k, n_per_span, step);
      double a = t * t;
      double b = a * t;
      double x = 0.5 * (2.0 * p1x + (-p0x + p2x) * t +
                        (2.0 * p0x - 5.0 * p1x + 4.0 * p2x - p3x) * a +
                        (-p0x + 3.0 * p1x - 3.0 * p2x + p3x) * b);
      double y = 0.5 * (2.0 * p1y + (-p0y + p2y) * t +
                        (2.0 * p0y - 5.0 * p1y + 4.0 * p2y - p3y) * a +
                        (-p0y + 3.0 * p1y - 3.0 * p2y + p3y) * b);
      out->emplace_back(x, y);
    }
  }
}

// curves.py:get_circle_center — returns false when collinear.
static bool circle_center(double ax, double ay, double bx, double by,
                          double cx, double cy, double* ux, double* uy) {
  double d = 2.0 * (ax * (by - cy) + bx * (cy - ay) + cx * (ay - by));
  if (std::fabs(d) < 1e-9) return false;
  double a2 = ax * ax + ay * ay, b2 = bx * bx + by * by, c2 = cx * cx + cy * cy;
  *ux = (a2 * (by - cy) + b2 * (cy - ay) + c2 * (ay - by)) / d;
  *uy = (a2 * (cx - bx) + b2 * (ax - cx) + c2 * (bx - ax)) / d;
  return true;
}

// curves.py:Perfect._build
static void perfect_points(const std::vector<std::pair<double, double>>& pts,
                           double ux, double uy,
                           std::vector<std::pair<double, double>>* out) {
  double ax = pts[0].first, ay = pts[0].second;
  double bx = pts[1].first, by = pts[1].second;
  double cx = pts[2].first, cy = pts[2].second;
  double radius = std::hypot(ax - ux, ay - uy);
  double theta0 = std::atan2(ay - uy, ax - ux);
  double theta1 = std::atan2(by - uy, bx - ux);
  double theta2 = std::atan2(cy - uy, cx - ux);
  auto sweep_fn = [](double t_from, double t_to, bool ccw) {
    double d = t_to - t_from;
    if (ccw) { while (d < 0) d += 2.0 * M_PI; }
    else { while (d > 0) d -= 2.0 * M_PI; }
    return d;
  };
  double ccw_mid = sweep_fn(theta0, theta1, true);
  double ccw_end = sweep_fn(theta0, theta2, true);
  bool ccw = ccw_mid <= ccw_end;
  double sweep = sweep_fn(theta0, theta2, ccw);
  int n = std::max(8, (int)py_int(std::fabs(sweep) * radius / 2.0));
  n = std::min(n, 4096);
  double step = 1.0 / (double)(n - 1);
  for (int i = 0; i < n; ++i) {
    double ang = theta0 + sweep * linspace01(i, n, step);
    out->emplace_back(ux + radius * std::cos(ang), uy + radius * std::sin(ang));
  }
}

// curves.py:MultiBezier._build
static void multibezier_points(const std::vector<std::pair<double, double>>& c,
                               std::vector<std::pair<double, double>>* out) {
  std::vector<std::pair<double, double>> verts;
  int seg_start = 0;
  int n = (int)c.size();
  bool any = false;
  for (int i = 1; i < n; ++i) {
    bool is_red = c[i].first == c[i - 1].first && c[i].second == c[i - 1].second;
    if (is_red || i == n - 1) {
      int end = is_red ? i : i + 1;
      int seg_len = end - seg_start;
      if (seg_len >= 2) {
        std::vector<std::pair<double, double>> seg(c.begin() + seg_start,
                                                   c.begin() + end);
        bezier_points(seg, SAMPLES_PER_SEGMENT * std::max(1, seg_len - 1), out);
        any = true;
      } else if (seg_len == 1) {
        out->push_back(c[seg_start]);
        any = true;
      }
      seg_start = i;
    }
  }
  if (!any) *out = c;
}

// curve_from_kind + Curve.__call__(t): build polyline, arc-length position.
// Only evaluated lazily for REPEAT_END (parser.py:477).
static void curve_position(const HitObject& ho, double t, double* ox, double* oy) {
  std::vector<std::pair<double, double>> verts;
  char k = ho.curve_kind;
  if (k == 'L') {
    verts = ho.points;
  } else if (k == 'C') {
    catmull_points(ho.points, &verts);
  } else if (k == 'P' && ho.points.size() == 3) {
    double ux, uy;
    if (circle_center(ho.points[0].first, ho.points[0].second,
                      ho.points[1].first, ho.points[1].second,
                      ho.points[2].first, ho.points[2].second, &ux, &uy)) {
      perfect_points(ho.points, ux, uy, &verts);
    } else {
      multibezier_points(ho.points, &verts);
    }
  } else {
    multibezier_points(ho.points, &verts);
  }
  // curves.py:_polyline_position
  size_t nseg = verts.size() > 0 ? verts.size() - 1 : 0;
  std::vector<double> seg_len(nseg), cum(nseg + 1);
  cum[0] = 0.0;
  for (size_t i = 0; i < nseg; ++i) {
    double dx = verts[i + 1].first - verts[i].first;
    double dy = verts[i + 1].second - verts[i].second;
    seg_len[i] = std::hypot(dx, dy);
    cum[i + 1] = cum[i] + seg_len[i];
  }
  double total = cum[nseg];
  double target = t * ho.pixel_length;
  if (total <= 1e-9) {
    *ox = verts.back().first; *oy = verts.back().second;
    return;
  }
  if (target >= total) {
    for (long i = (long)nseg - 1; i >= 0; --i) {
      if (seg_len[i] > 1e-9) {
        double dx = (verts[i + 1].first - verts[i].first) / seg_len[i];
        double dy = (verts[i + 1].second - verts[i].second) / seg_len[i];
        *ox = verts[i + 1].first + dx * (target - total);
        *oy = verts[i + 1].second + dy * (target - total);
        return;
      }
    }
    *ox = verts.back().first; *oy = verts.back().second;
    return;
  }
  auto it = std::upper_bound(cum.begin(), cum.end(), target);
  long idx = (long)(it - cum.begin()) - 1;
  idx = std::min(std::max(idx, 0L), (long)nseg - 1);
  double denom = seg_len[idx] > 1e-9 ? seg_len[idx] : 1.0;
  double frac = (target - cum[idx]) / denom;
  *ox = verts[idx].first + (verts[idx + 1].first - verts[idx].first) * frac;
  *oy = verts[idx].second + (verts[idx + 1].second - verts[idx].second) * frac;
}

// ------------------------------------------------------------ event groups

// EventType declaration order in cm3p_torch/beatmap/events.py — index = id here.
enum EvType {
  EV_CIRCLE = 0, EV_SPINNER, EV_SPINNER_END, EV_SLIDER_HEAD, EV_BEZIER_ANCHOR,
  EV_PERFECT_ANCHOR, EV_CATMULL_ANCHOR, EV_RED_ANCHOR, EV_LAST_ANCHOR,
  EV_SLIDER_END, EV_REPEAT_END, EV_BEAT, EV_MEASURE, EV_TIMING_POINT,
  EV_KIAI_ON, EV_KIAI_OFF, EV_HOLD_NOTE, EV_HOLD_NOTE_END,
  EV_SCROLL_SPEED_CHANGE, EV_DRUMROLL, EV_DRUMROLL_END, EV_DENDEN,
  EV_DENDEN_END, EV_COUNT
};

struct Group {
  int32_t event_type = 0;
  int64_t time = 0;
  uint8_t has_time = 0;
  int32_t snapping = -1;      // -1 = None
  int32_t distance = INT32_MIN;  // INT32_MIN = None
  int32_t x = INT32_MIN, y = INT32_MIN;
  int32_t mania_column = INT32_MIN;
  uint8_t new_combo = 0;
  uint8_t has_ss = 0;
  double scroll_speed = 0.0;
  int32_t hs_off = 0, hs_cnt = 0;  // into EventStream hitsound arrays
};

struct ParserConfig {
  int32_t add_timing, add_snapping, add_timing_points, add_hitsounds;
  int32_t add_distances, add_positions, add_kiai, add_sv, add_mania_sv;
  int32_t mania_bpm_normalized_scroll_speed;
  int32_t slider_version;
  int32_t emit_mania_column;
};

struct EventStream {
  std::vector<Group> groups;
  std::vector<int32_t> hs, ss, as_, vol;  // flattened hitsound quads
  bool error = false;  // python path would raise; caller must fall back
};

struct Lowering {
  const BeatmapData& bm;
  const ParserConfig& cfg;
  EventStream* out;
  double last_x = 256.0, last_y = 192.0;

  // parser.py:_get_snapping
  int get_snapping(double time_ms, bool add_snap) const {
    if (!add_snap || !cfg.add_snapping) return -1;
    int ti = uninherited_point_at(bm, time_ms);
    if (ti < 0) { out->error = true; return -1; }
    const TimingPoint& tp = bm.tps[ti];
    // python raises on /0 (ZeroDivisionError) and round(nan) (ValueError)
    if (tp.ms_per_beat == 0.0 || std::isnan(tp.ms_per_beat)) {
      out->error = true;
      return 0;
    }
    // replicate the reference's timedelta chain bit-for-bit (see
    // parser.py:_get_snapping): integer-microsecond quantization, exact
    // subtraction, then /1e6 * 1000 — one ulp off exact float ms, which
    // decides 2 ms-tolerance boundary cases
    double d_us = (double)py_round(time_ms * 1000.0) - (double)py_round(tp.offset * 1000.0);
    double beats = (d_us / 1e6) * 1000.0 / tp.ms_per_beat;
    for (int i = 1; i <= 16; ++i) {
      double r = (double)py_round(beats * (double)i) / (double)i;
      if (std::fabs(beats - r) * tp.ms_per_beat < 2.0) return i;
    }
    return 0;
  }

  // parser.py:_get_hitsounds (returns false on malformed addition -> py raise)
  bool get_hitsounds(double time_ms, int hitsound, const std::string& addition,
                     int* h, int* s, int* a, int* v) const {
    int ti = timing_point_at(bm, time_ms + 5.0);
    if (ti < 0) { return false; }
    const TimingPoint& tp = bm.tps[ti];
    int tp_sample_set = tp.sample_type != 0 ? tp.sample_type : 2;
    std::vector<std::string> sp;
    split(addition, ':', &sp);
    if (sp.size() < 2) return false;  // py split[1] IndexError
    long long sample_set, addition_set, volume;
    // python compares the UNtrimmed token to "0" (int() then strips spaces)
    if (sp[0] != "0") { if (!py_strict_int(sp[0], &sample_set)) return false; }
    else sample_set = tp_sample_set;
    if (sp[1] != "0") { if (!py_strict_int(sp[1], &addition_set)) return false; }
    else addition_set = sample_set;
    if (sp.size() > 3) {
      if (sp[3] != "0") { if (!py_strict_int(sp[3], &volume)) return false; }
      else volume = tp.volume;
    } else {
      volume = tp.volume;
    }
    if (!(0 < sample_set && sample_set < 4)) sample_set = 1;
    if (!(0 < addition_set && addition_set < 4)) addition_set = 1;
    *h = hitsound & 14;
    *s = (int)sample_set;
    *a = (int)addition_set;
    *v = (int)std::min(std::max(volume, 0LL), 100LL);
    return true;
  }

  // parser.py:tp_to_scroll_speed via scroll_speed_at
  double scroll_speed_at(double time_ms) const {
    int ti = timing_point_at(bm, time_ms);
    if (ti < 0) { out->error = true; return 1.0; }
    const TimingPoint& tp = bm.tps[ti];
    if (tp.parent < 0 || tp.ms_per_beat >= 0 || std::isnan(tp.ms_per_beat))
      return 1.0;
    return std::min(std::max(-100.0 / tp.ms_per_beat, 0.01), 10.0);
  }

  // parser.py:_add_group. pos/last given via has_pos; hitsound refs appended
  // by the caller into the stream arrays before calling when needed.
  void add_group(int ev, double time, bool has_time, bool add_snap,
                 bool has_pos, double px, double py_v, bool new_combo,
                 bool has_ss, double ss_val,
                 const double* hs_ref_times, const int* hs_sounds,
                 const std::string* hs_additions, int hs_n) {
    Group g;
    g.event_type = ev;
    g.time = py_int(time + 1e-5);
    if (has_time) {
      g.has_time = 1;
      g.snapping = get_snapping(time, add_snap);
    }
    if (has_pos) {
      if (bm.mode == 0 || bm.mode == 2) {
        if (cfg.add_distances) {
          double dx = px - last_x, dy = py_v - last_y;
          g.distance = (int32_t)py_int(std::sqrt(dx * dx + dy * dy));
        }
        if (cfg.add_positions) {
          g.x = (int32_t)py_int(px);
          g.y = (int32_t)py_int(py_v);
        }
        last_x = px; last_y = py_v;
      } else if (bm.mode == 3 && cfg.emit_mania_column) {
        double columns = bm.circle_size;
        double c = px / 512.0 * columns;
        c = std::min(std::max(c, 0.0), columns - 1.0);
        g.mania_column = (int32_t)py_int(c);
      }
    }
    if (new_combo && (bm.mode == 0 || bm.mode == 2)) g.new_combo = 1;
    if (has_ss) { g.has_ss = 1; g.scroll_speed = ss_val; }
    if (hs_n > 0 && cfg.add_hitsounds) {
      g.hs_off = (int32_t)out->hs.size();
      for (int i = 0; i < hs_n; ++i) {
        int h, s, a, v;
        if (!get_hitsounds(hs_ref_times[i], hs_sounds[i], hs_additions[i],
                           &h, &s, &a, &v)) {
          out->error = true;
          return;
        }
        out->hs.push_back(h); out->ss.push_back(s);
        out->as_.push_back(a); out->vol.push_back(v);
      }
      g.hs_cnt = hs_n;
    }
    out->groups.push_back(g);
  }
};

// events.py:_td_floor_seconds_ms
static long long td_floor_seconds_ms(double ms) {
  double days = std::floor(ms / 86400000.0);
  double rem = ms - days * 86400000.0;
  return (long long)(std::floor(rem / 1000.0)) * 1000LL;
}

// events.py:get_median_mpb (+ get_median_mpb_beatmap last-time rule)
static double median_mpb(const BeatmapData& bm) {
  double last = -1e300;
  for (const auto& ho : bm.hos) {
    double t = ho.kind == HO_HOLD ? ho.end_time : ho.time;
    if (t > last) last = t;
  }
  long long last_time = td_floor_seconds_ms(last);
  double this_beat_length = 0.0;
  // insertion-ordered dict
  std::vector<std::pair<double, long long>> durations;
  for (int i = (int)bm.tps.size() - 1; i >= 0; --i) {
    const TimingPoint& tp = bm.tps[i];
    long long offset = td_floor_seconds_ms(tp.offset);
    if (tp.parent < 0) this_beat_length = tp.ms_per_beat;
    if (this_beat_length == 0.0 || offset > last_time ||
        (tp.parent >= 0 && i > 0))
      continue;
    long long duration = last_time - (i == 0 ? 0 : offset);
    bool found = false;
    for (auto& kv : durations)
      if (kv.first == this_beat_length) { kv.second += duration; found = true; break; }
    if (!found) durations.emplace_back(this_beat_length, duration);
    last_time = offset;
  }
  long long longest = 0;
  double median = 0.0;
  for (const auto& kv : durations)
    if (kv.second > longest) { longest = kv.second; median = kv.first; }
  return median;
}

// events.py:merge_groups with falsy-time carry-forward.
static void merge_groups(std::vector<Group>& g1, std::vector<Group>& g2,
                         std::vector<Group>* out) {
  size_t i = 0, j = 0;
  double t1 = -1e300, t2 = -1e300;
  out->reserve(g1.size() + g2.size());
  while (i < g1.size() && j < g2.size()) {
    if (g1[i].time != 0) t1 = (double)g1[i].time;
    if (g2[j].time != 0) t2 = (double)g2[j].time;
    if (t1 <= t2) out->push_back(g1[i++]);
    else out->push_back(g2[j++]);
  }
  for (; i < g1.size(); ++i) out->push_back(g1[i]);
  for (; j < g2.size(); ++j) out->push_back(g2[j]);
}

static EventStream* lower_events(const BeatmapData& bm, const ParserConfig& cfg,
                                 double speed, double song_length_sec) {
  auto* out = new EventStream();
  if (bm.parse_error) { out->error = true; return out; }
  Lowering L{bm, cfg, out};

  // ---- per-object groups (parser.py:135-149)
  for (const auto& ho : bm.hos) {
    if (out->error) return out;
    if (ho.kind == HO_CIRCLE) {
      double t = ho.time;
      int hs = ho.hitsound;
      bool taiko = bm.mode == 1;
      double ssv = taiko ? L.scroll_speed_at(t) : 0.0;
      L.add_group(EV_CIRCLE, t, true, true, true, ho.x, ho.y, ho.new_combo,
                  taiko, ssv, &t, &hs, &ho.addition, 1);
    } else if (ho.kind == HO_SLIDER) {
      if (bm.mode == 1) {
        // _parse_drumroll
        double t = ho.time;
        int hs = ho.hitsound;
        L.add_group(EV_DRUMROLL, t, true, true, false, 0, 0, false, true,
                    L.scroll_speed_at(t), &t, &hs, &ho.addition, 1);
        L.add_group(EV_DRUMROLL_END, ho.end_time, true, true, false, 0, 0,
                    false, false, 0, nullptr, nullptr, nullptr, 0);
        continue;
      }
      // _parse_slider
      if ((int)ho.points.size() >= 100) continue;  // degenerate art sliders
      {
        double t = ho.time;
        int hs = ho.edge_sounds.size() > 0 ? ho.edge_sounds[0] : 0;
        std::string ad = ho.edge_additions.size() > 0 ? ho.edge_additions[0]
                                                      : std::string("0:0");
        bool has_ss = cfg.add_sv != 0;
        L.add_group(EV_SLIDER_HEAD, t, true, true, true, ho.x, ho.y,
                    ho.new_combo, has_ss, has_ss ? L.scroll_speed_at(t) : 0.0,
                    &t, &hs, &ad, 1);
      }
      double duration = (ho.end_time - ho.time) / (double)ho.repeat;
      int cpc = (int)ho.points.size();
      auto add_anchor = [&](int ev, int i) {
        double t = cfg.slider_version == 1
                       ? ho.time + (double)i / (double)(cpc - 1) * duration
                       : ho.time;
        L.add_group(ev, t, false, true, true, ho.points[i].first,
                    ho.points[i].second, false, false, 0,
                    nullptr, nullptr, nullptr, 0);
      };
      char k = ho.curve_kind;
      bool perfect_ok = false;
      if (k == 'P' && cpc == 3) {
        double ux, uy;
        perfect_ok = circle_center(ho.points[0].first, ho.points[0].second,
                                   ho.points[1].first, ho.points[1].second,
                                   ho.points[2].first, ho.points[2].second,
                                   &ux, &uy);
      }
      if (k == 'L') {
        for (int i = 1; i < cpc - 1; ++i) add_anchor(EV_RED_ANCHOR, i);
      } else if (k == 'C') {
        for (int i = 1; i < cpc - 1; ++i) add_anchor(EV_CATMULL_ANCHOR, i);
      } else if (perfect_ok) {
        for (int i = 1; i < cpc - 1; ++i) add_anchor(EV_PERFECT_ANCHOR, i);
      } else {
        // MultiBezier (B, fallback P, unknown kinds)
        for (int i = 1; i < cpc - 1; ++i) {
          if (ho.points[i] == ho.points[i + 1]) add_anchor(EV_RED_ANCHOR, i);
          else if (!(ho.points[i] == ho.points[i - 1]))
            add_anchor(EV_BEZIER_ANCHOR, i);
        }
      }
      if (cfg.slider_version == 2) {
        L.add_group(EV_LAST_ANCHOR, ho.time, false, true, true,
                    ho.points.back().first, ho.points.back().second, false,
                    false, 0, nullptr, nullptr, nullptr, 0);
      }
      {
        // SLIDER_END: body hitsound + intermediate repeat-edge hitsounds
        int n = ho.repeat;  // 1 body + (repeat-1) edges
        std::vector<double> times(n);
        std::vector<int> sounds(n);
        std::vector<std::string> adds(n);
        times[0] = ho.time + 1.0;
        sounds[0] = ho.hitsound;
        adds[0] = ho.addition;
        for (int i = 1; i < n; ++i) {
          times[i] = ho.time + (double)i * duration;
          sounds[i] = (int)ho.edge_sounds.size() > i ? ho.edge_sounds[i] : 0;
          adds[i] = (int)ho.edge_additions.size() > i ? ho.edge_additions[i]
                                                      : std::string("0:0");
        }
        bool v1 = cfg.slider_version == 1;
        L.add_group(EV_SLIDER_END, ho.time + duration, true, true, v1,
                    ho.points.back().first, ho.points.back().second, false,
                    false, 0, times.data(), sounds.data(), adds.data(), n);
      }
      {
        double ex, ey;
        curve_position(ho, 1.0, &ex, &ey);
        double t = ho.end_time;
        int hs = ho.edge_sounds.size() > 0 ? ho.edge_sounds.back() : 0;
        std::string ad = ho.edge_additions.size() > 0 ? ho.edge_additions.back()
                                                      : std::string("0:0");
        L.add_group(EV_REPEAT_END, t, true, true, true, ex, ey, false, false,
                    0, &t, &hs, &ad, 1);
      }
    } else if (ho.kind == HO_SPINNER) {
      if (bm.mode == 1) {
        // _parse_denden
        double t = ho.time;
        int hs = ho.hitsound;
        L.add_group(EV_DENDEN, t, true, true, false, 0, 0, false, true,
                    L.scroll_speed_at(t), &t, &hs, &ho.addition, 1);
        L.add_group(EV_DENDEN_END, ho.end_time, true, true, false, 0, 0,
                    false, false, 0, nullptr, nullptr, nullptr, 0);
      } else {
        L.add_group(EV_SPINNER, ho.time, true, true, false, 0, 0, false,
                    false, 0, nullptr, nullptr, nullptr, 0);
        double t = ho.end_time;
        int hs = ho.hitsound;
        L.add_group(EV_SPINNER_END, t, true, true, false, 0, 0, false, false,
                    0, &t, &hs, &ho.addition, 1);
        L.last_x = 256.0; L.last_y = 192.0;
      }
    } else {  // HO_HOLD
      if (bm.mode == 0 || bm.mode == 2) {
        // python crashes here (_get_position with last_pos=None); fall back
        out->error = true;
        return out;
      }
      double t = ho.time;
      int hs = ho.hitsound;
      L.add_group(EV_HOLD_NOTE, t, true, true, true, ho.x, ho.y, false, false,
                  0, &t, &hs, &ho.addition, 1);
      L.add_group(EV_HOLD_NOTE_END, ho.end_time, true, true, true, ho.x, ho.y,
                  false, false, 0, nullptr, nullptr, nullptr, 0);
    }
  }
  if (out->error) return out;

  // stable sort by time (parser.py:152)
  std::stable_sort(out->groups.begin(), out->groups.end(),
                   [](const Group& a, const Group& b) { return a.time < b.time; });

  std::vector<Group> result = std::move(out->groups);
  out->groups.clear();

  // ---- mania scroll speeds (parser.py:171-201)
  if (cfg.add_mania_sv && bm.mode == 3) {
    if (bm.hos.empty()) { out->error = true; return out; }  // py max() raises
    std::vector<Group> sv_groups;
    {
      EventStream tmp;
      Lowering L2{bm, cfg, &tmp};
      double med = median_mpb(bm);
      double mpb = med;
      double last_speed = -1.0;
      for (size_t i = 0; i < bm.tps.size(); ++i) {
        const TimingPoint& tp = bm.tps[i];
        double scroll_speed;
        if (tp.parent < 0) { mpb = tp.ms_per_beat; scroll_speed = 1.0; }
        else scroll_speed = -100.0 / tp.ms_per_beat;
        if (i == bm.tps.size() - 1 || bm.tps[i + 1].offset > tp.offset) {
          double value = cfg.mania_bpm_normalized_scroll_speed
                             ? scroll_speed * med / mpb
                             : scroll_speed;
          if (value != last_speed || last_speed == -1.0) {
            L2.add_group(EV_SCROLL_SPEED_CHANGE, tp.offset, true, true, false,
                         0, 0, false, true, value, nullptr, nullptr, nullptr, 0);
          }
          last_speed = value;
        }
      }
      if (tmp.error) { out->error = true; return out; }
      sv_groups = std::move(tmp.groups);
    }
    std::vector<Group> merged;
    merge_groups(sv_groups, result, &merged);
    result = std::move(merged);
  }

  // ---- kiai toggles (parser.py:203-218)
  if (cfg.add_kiai) {
    std::vector<Group> kiai_groups;
    {
      EventStream tmp;
      Lowering L2{bm, cfg, &tmp};
      bool kiai = false;
      for (const auto& tp : bm.tps) {
        if (tp.kiai == kiai) continue;
        L2.add_group(tp.kiai ? EV_KIAI_ON : EV_KIAI_OFF, tp.offset, true, true,
                     false, 0, 0, false, false, 0, nullptr, nullptr, nullptr, 0);
        kiai = tp.kiai;
      }
      if (tmp.error) { out->error = true; return out; }
      kiai_groups = std::move(tmp.groups);
    }
    std::vector<Group> merged;
    merge_groups(kiai_groups, result, &merged);
    result = std::move(merged);
  }

  // ---- timing grid (parser.py:220-260)
  if (cfg.add_timing) {
    if (bm.tps.empty()) { out->error = true; return out; }  // python asserts
    std::vector<Group> timing_groups;
    {
      EventStream tmp;
      Lowering L2{bm, cfg, &tmp};
      long long last_time = (long long)py_int(song_length_sec * 1000.0);
      std::vector<int> tpi;
      for (size_t i = 0; i < bm.tps.size(); ++i)
        if (bm.tps[i].has_bpm()) tpi.push_back((int)i);
      for (size_t i = 0; i < tpi.size(); ++i) {
        const TimingPoint& tp = bm.tps[tpi[i]];
        double next_time = i + 1 < tpi.size() ? bm.tps[tpi[i + 1]].offset - 10.0
                                              : (double)last_time;
        double start_time = tp.offset;
        double time = start_time;
        long long measure_counter = 0;
        double beat_delta = tp.ms_per_beat;
        int meter = tp.meter > 0 ? tp.meter : 4;
        while (time <= next_time) {
          int ev;
          if (cfg.add_timing_points && measure_counter == 0) ev = EV_TIMING_POINT;
          else if (measure_counter % meter == 0) ev = EV_MEASURE;
          else ev = EV_BEAT;
          L2.add_group(ev, time, true, false, false, 0, 0, false, false, 0,
                       nullptr, nullptr, nullptr, 0);
          if (beat_delta <= 10.0) break;
          measure_counter += 1;
          time = start_time + (double)measure_counter * beat_delta;
        }
      }
      timing_groups = std::move(tmp.groups);
    }
    std::vector<Group> merged;
    merge_groups(timing_groups, result, &merged);
    result = std::move(merged);
  }

  // ---- DT speed scaling (events.py:speed_groups: int(time / speed))
  if (speed != 1.0) {
    for (auto& g : result) g.time = py_int((double)g.time / speed);
  }

  out->groups = std::move(result);
  return out;
}

// ----------------------------------------------------------- token tables

struct TokTables {
  // specials
  int32_t cls_id;  // -1 when add_cls_token is false
  int32_t bos_id, eos_id, audio_bos_id, audio_id, audio_eos_id;
  int32_t nc_id;   // -1 when separate_new_combo_token is false
  // per-event ids (EV_COUNT each); nc variant valid for circle/slider_head
  const int32_t* event_ids;
  const int32_t* event_nc_ids;
  // time shift: qi = rint(clamp(t)/step); id = ts[qi - ts_qmin]
  int64_t ts_qmin, ts_qmax;
  double ts_min, ts_max, ts_step;
  const int32_t* ts;
  // snapping 0..16
  const int32_t* snap;
  // distance: qi = rint(clamp(d)/step)
  int64_t dist_qmax;
  double dist_max, dist_step;
  const int32_t* dist;
  // positions
  int32_t pos_split;
  double pos_x_min, pos_x_max, pos_y_min, pos_y_max, pos_step;
  int64_t pos_qx_min, pos_qx_max, pos_qy_min, pos_qy_max;
  const int32_t* pos_x;   // split mode
  const int32_t* pos_y;   // split mode
  const int32_t* pos_xy;  // combined mode, row-major (qx, qy)
  // mania column ids for columns 1..18
  const int32_t* mania;
  // scroll speed: key = rint(clamp(ss,0,10)/0.01), ids for 0..1000
  const int32_t* ss;
  // hitsounds: idx = (h>>1)*9 + (s-1)*3 + (a-1)
  const int32_t* hs;
  // volume 0..100
  const int32_t* vol;
};

// tokenizer encode_groups + _encode_single for one window.
// Returns the emitted length (<= max_len after truncation).
static int encode_window(const EventStream& ev, const TokTables& tt,
                         size_t g0, size_t g1, double window_start_ms,
                         int num_audio_tokens, int32_t* out, int max_len) {
  int n = 0;
  auto emit = [&](int32_t id) {
    if (n < max_len) out[n] = id;
    ++n;
  };
  if (num_audio_tokens > 0) {
    emit(tt.audio_bos_id);
    for (int i = 0; i < num_audio_tokens; ++i) emit(tt.audio_id);
    emit(tt.audio_eos_id);
  }
  if (tt.cls_id >= 0) emit(tt.cls_id);
  emit(tt.bos_id);
  bool sep_nc = tt.nc_id >= 0;
  for (size_t gi = g0; gi < g1; ++gi) {
    const Group& g = ev.groups[gi];
    bool with_nc_variant =
        g.new_combo && !sep_nc &&
        (g.event_type == EV_CIRCLE || g.event_type == EV_SLIDER_HEAD);
    emit(with_nc_variant ? tt.event_nc_ids[g.event_type]
                         : tt.event_ids[g.event_type]);
    if (g.has_time) {
      double t = (double)g.time - window_start_ms;
      t = std::min(std::max(t, tt.ts_min), tt.ts_max);
      long long qi = py_round(t / tt.ts_step);
      emit(tt.ts[qi - tt.ts_qmin]);
      if (g.snapping >= 0) emit(tt.snap[g.snapping]);
    }
    if (g.distance != INT32_MIN) {
      double d = std::min(std::max((double)g.distance, 0.0), tt.dist_max);
      long long qi = py_round(d / tt.dist_step);
      emit(tt.dist[qi]);
    }
    if (g.x != INT32_MIN && g.y != INT32_MIN) {
      double px = std::min(std::max((double)g.x, tt.pos_x_min), tt.pos_x_max);
      double py_v = std::min(std::max((double)g.y, tt.pos_y_min), tt.pos_y_max);
      long long qx = py_round(px / tt.pos_step);
      long long qy = py_round(py_v / tt.pos_step);
      if (tt.pos_split) {
        emit(tt.pos_x[qx - tt.pos_qx_min]);
        emit(tt.pos_y[qy - tt.pos_qy_min]);
      } else {
        long long ny = tt.pos_qy_max - tt.pos_qy_min + 1;
        emit(tt.pos_xy[(qx - tt.pos_qx_min) * ny + (qy - tt.pos_qy_min)]);
      }
    }
    if (g.mania_column != INT32_MIN) {
      long long c = g.mania_column;
      c = std::min(std::max(c, 1LL), 18LL);
      emit(tt.mania[c - 1]);
    }
    if (g.new_combo && sep_nc) emit(tt.nc_id);
    if (g.has_ss) {
      if (std::isnan(g.scroll_speed)) return -1;  // python round(nan) raises
      double v = std::min(std::max(g.scroll_speed, 0.0), 10.0);
      long long key = py_round(v / 0.01);
      emit(tt.ss[key]);
    }
    for (int i = 0; i < g.hs_cnt; ++i) {
      int h = ev.hs[g.hs_off + i], s = ev.ss[g.hs_off + i],
          a = ev.as_[g.hs_off + i], v = ev.vol[g.hs_off + i];
      // clamp exactly like _tokenize_hitsound (already-clamped inputs pass
      // through unchanged)
      int hh = std::min(std::max(h >> 1, 0), 7);
      int ss_ = std::min(std::max(s, 1), 3);
      int aa = std::min(std::max(a, 1), 3);
      emit(tt.hs[hh * 9 + (ss_ - 1) * 3 + (aa - 1)]);
      emit(tt.vol[std::min(std::max(v, 0), 100)]);
    }
  }
  emit(tt.eos_id);
  return std::min(n, max_len);
}

}  // namespace

// ------------------------------------------------------------------- C ABI

CT_EXPORT void* ct_beatmap_parse(const char* text, int64_t len) {
  return parse_osu(text, (size_t)len);
}

CT_EXPORT void ct_beatmap_free(void* h) { delete (BeatmapData*)h; }

// get_metadata() inputs the python path derives from the Beatmap object.
struct CtSummary {
  int32_t mode;
  int32_t n_hit_objects;
  int32_t hitsounded;
  int32_t parse_error;
  double circle_size;
  double slider_multiplier;
  double hold_note_ratio;     // valid when n_hit_objects > 0
  double scroll_speed_ratio;  // valid when n_hit_objects > 0
  double last_ho_for_length;  // end_time/time of LAST object; NaN if none
  double last_tp_offset;      // NaN if none
};

CT_EXPORT void ct_beatmap_summary(const void* h, CtSummary* s) {
  const auto& bm = *(const BeatmapData*)h;
  s->mode = bm.mode;
  s->n_hit_objects = (int32_t)bm.hos.size();
  s->circle_size = bm.circle_size;
  s->slider_multiplier = bm.slider_multiplier;
  s->parse_error = bm.parse_error ? 1 : 0;
  s->hitsounded = 0;
  for (const auto& ho : bm.hos)
    if (ho.hitsound != 0) { s->hitsounded = 1; break; }
  // processor.py:get_hold_note_ratio / get_scroll_speed_ratio
  if (!bm.hos.empty()) {
    long long hold = 0;
    for (const auto& ho : bm.hos) hold += ho.kind == HO_HOLD ? 1 : 0;
    s->hold_note_ratio = (double)hold / (double)bm.hos.size();
    double last_time = -1.0;
    long long num_note_times = 0;
    for (const auto& ho : bm.hos) {
      if (ho.time != last_time) { ++num_note_times; last_time = ho.time; }
    }
    double last_speed = -1.0;
    long long num_changes = 0;
    for (const auto& tp : bm.tps) {
      if (tp.parent < 0) last_speed = 1.0;
      else {
        double sp = -100.0 / tp.ms_per_beat;
        if (sp != last_speed && last_speed != -1.0) ++num_changes;
        last_speed = sp;
      }
    }
    s->scroll_speed_ratio = (double)num_changes / (double)num_note_times;
  } else {
    s->hold_note_ratio = std::nan("");
    s->scroll_speed_ratio = std::nan("");
  }
  if (!bm.hos.empty()) {
    const HitObject& last = bm.hos.back();
    s->last_ho_for_length = last.kind == HO_CIRCLE ? last.time : last.end_time;
  } else {
    s->last_ho_for_length = std::nan("");
  }
  s->last_tp_offset = bm.tps.empty() ? std::nan("") : bm.tps.back().offset;
}

CT_EXPORT void* ct_parse_events(const void* h, const ParserConfig* cfg,
                                double speed, double song_length_sec) {
  return lower_events(*(const BeatmapData*)h, *cfg, speed, song_length_sec);
}

CT_EXPORT void ct_events_free(void* e) { delete (EventStream*)e; }

CT_EXPORT int64_t ct_events_count(const void* e) {
  const auto* ev = (const EventStream*)e;
  return ev->error ? -1 : (int64_t)ev->groups.size();
}

CT_EXPORT int64_t ct_events_hs_count(const void* e) {
  return (int64_t)((const EventStream*)e)->hs.size();
}

// time of the last group (the processor's past-audio-tail warning input);
// INT64_MIN when the stream is empty.
CT_EXPORT int64_t ct_events_last_time(const void* e) {
  const auto& ev = *(const EventStream*)e;
  return ev.groups.empty() ? INT64_MIN : ev.groups.back().time;
}

// Parallel-array export for parity tests and the python-Group adapter.
// None encodings: snapping -1; distance/x/y/mania INT32_MIN; scroll via has_ss.
CT_EXPORT void ct_events_export(const void* e, int32_t* event_type,
                                int64_t* time, uint8_t* has_time,
                                int32_t* snapping, int32_t* distance,
                                int32_t* x, int32_t* y, int32_t* mania_column,
                                uint8_t* new_combo, uint8_t* has_ss,
                                double* scroll_speed, int32_t* hs_off,
                                int32_t* hs_cnt, int32_t* hs, int32_t* ss,
                                int32_t* as_, int32_t* vol) {
  const auto& ev = *(const EventStream*)e;
  for (size_t i = 0; i < ev.groups.size(); ++i) {
    const Group& g = ev.groups[i];
    event_type[i] = g.event_type;
    time[i] = g.time;
    has_time[i] = g.has_time;
    snapping[i] = g.snapping;
    distance[i] = g.distance;
    x[i] = g.x;
    y[i] = g.y;
    mania_column[i] = g.mania_column;
    new_combo[i] = g.new_combo;
    has_ss[i] = g.has_ss;
    scroll_speed[i] = g.scroll_speed;
    hs_off[i] = g.hs_off;
    hs_cnt[i] = g.hs_cnt;
  }
  if (!ev.hs.empty()) {
    std::memcpy(hs, ev.hs.data(), ev.hs.size() * sizeof(int32_t));
    std::memcpy(ss, ev.ss.data(), ev.ss.size() * sizeof(int32_t));
    std::memcpy(as_, ev.as_.data(), ev.as_.size() * sizeof(int32_t));
    std::memcpy(vol, ev.vol.data(), ev.vol.size() * sizeof(int32_t));
  }
}

// Window slice + tokenize. Replicates the processor's sequential scan
// (processor.py:486-506) and pack_sequences padding into caller buffers.
// out_ids/out_mask are (n_windows, target_len) int32, pre-filled by the
// caller with pad_id / 0. Returns 0 on success.
CT_EXPORT int32_t ct_tokenize_windows(
    const void* e, const TokTables* tt, const double* start_ms,
    const double* end_ms, const double* next_start_ms, int64_t n_windows,
    const int32_t* num_audio_tokens, int32_t max_length, int32_t target_len,
    int32_t* out_ids, int32_t* out_mask, int32_t* out_lens) {
  const auto& ev = *(const EventStream*)e;
  if (ev.error) return -1;
  size_t search = 0;
  std::vector<int32_t> buf((size_t)max_length);
  for (int64_t w = 0; w < n_windows; ++w) {
    // sequential scan, including its exact skip/break semantics
    size_t i = search;
    size_t g0 = SIZE_MAX, g1 = SIZE_MAX;
    for (; i < ev.groups.size(); ++i) {
      double t = (double)ev.groups[i].time;
      if (t < next_start_ms[w]) search = i + 1;
      if (t < start_ms[w]) continue;
      else if (t < end_ms[w]) { if (g0 == SIZE_MAX) g0 = i; }
      else break;
    }
    g1 = i;
    if (g0 == SIZE_MAX) g0 = g1;  // empty window
    // NB: the python loop appends groups where start<=t<end scanning from
    // search; with non-decreasing times this is the contiguous [g0, g1).
    // Out-of-order times inside a window would interleave skipped groups —
    // times are sorted post-merge, but guard anyway:
    for (size_t j = g0; j < g1; ++j) {
      if ((double)ev.groups[j].time < start_ms[w]) return -2;
    }
    int len = encode_window(ev, *tt, g0, g1, start_ms[w],
                            num_audio_tokens ? num_audio_tokens[w] : 0,
                            buf.data(), max_length);
    if (len < 0) return -3;
    int n = std::min(len, target_len);
    int32_t* row_ids = out_ids + (size_t)w * target_len;
    int32_t* row_mask = out_mask + (size_t)w * target_len;
    std::memcpy(row_ids, buf.data(), (size_t)n * sizeof(int32_t));
    for (int k = 0; k < n; ++k) row_mask[k] = 1;
    out_lens[w] = n;
  }
  return 0;
}

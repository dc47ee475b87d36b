// Host-side serial fast marching for levelset reinitialization with
// optional velocity value-transport.
//
// Reference-exact reimplementation of the algorithm in
// source/fastmarch.cpp (FastMarch<FmHeapEntryIn,-1> / <FmHeapEntryOut,+1>,
// calcWeights/calculateDistance/addToList/performMarching,
// FmValueTransportVec3) and source/levelset.cpp doReinitMarch
// (InitFmIn/InitFmOut/SetUninitialized/isAtInterface, the init scans and
// the correctOuterLayer seeding). The fast march is inherently a serial
// heap algorithm (SURVEY.md §2.15.6) so it runs on the host; grids are
// float32/int32 row-major [z,y,x] (x fastest — same flat layout as the
// reference's i + sx*j + sx*sy*k).
//
// Build: g++ -O2 -shared -fPIC fastmarch.cpp -o libfastmarch.so

#include <cmath>
#include <cstdint>
#include <queue>
#include <vector>

namespace {

constexpr int kInited = 1;
constexpr int kOnHeap = 2;

constexpr int kFluid = 1, kObstacle = 2, kEmpty = 4;

struct Ctx {
    float* phi;
    const int32_t* flags;
    float* vel;  // component-major (3, n) or nullptr
    int sx, sy, sz;
    bool is3d;
    int64_t n;
    std::vector<int32_t> fm;

    int64_t idx(int x, int y, int z) const {
        return (int64_t)x + (int64_t)sx * ((int64_t)y + (int64_t)sy * z);
    }
    bool inBounds(int x, int y, int z, int b) const {
        if (x < b || y < b || x >= sx - b || y >= sy - b) return false;
        if (is3d && (z < b || z >= sz - b)) return false;
        return true;
    }
    bool isEmpty(int x, int y, int z) const {
        return (flags[idx(x, y, z)] & kEmpty) != 0;
    }
};

const int kNb[6][3] = {{-1, 0, 0}, {1, 0, 0}, {0, -1, 0},
                       {0, 1, 0},  {0, 0, -1}, {0, 0, 1}};

struct HeapEntry {
    int x, y, z;
    float time;
};

// pop order: smallest time first for the outward march (dir=+1), largest
// first for the inward march (dir=-1); ties broken on (z,y,x) exactly as
// the reference heap comparators do.
template <int DIR>
struct Later {
    bool operator()(const HeapEntry& a, const HeapEntry& b) const {
        if (a.time != b.time)
            return DIR > 0 ? (a.time > b.time) : (a.time < b.time);
        if (a.z != b.z) return DIR > 0 ? (a.z > b.z) : (a.z < b.z);
        if (a.y != b.y) return DIR > 0 ? (a.y > b.y) : (a.y < b.y);
        return DIR > 0 ? (a.x > b.x) : (a.x < b.x);
    }
};

template <int DIR>
class Marcher {
 public:
    Marcher(Ctx& c, float maxTime, bool transport)
        : c_(c), maxTime_(maxTime * DIR), transport_(transport) {}

    // one axis of the upwind stencil: pick the inited +1 neighbor first,
    // else the -1 neighbor (calcWeights)
    template <int AX>
    float axisValue(int x, int y, int z, int& ok, int& bad, float* v) {
        int px = x + (AX == 0), py = y + (AX == 1), pz = z + (AX == 2);
        int mx = x - (AX == 0), my = y - (AX == 1), mz = z - (AX == 2);
        w_[AX * 2] = w_[AX * 2 + 1] = 0.f;
        float val = 0.f;
        if (c_.fm[c_.idx(px, py, pz)] == kInited) {
            val = c_.phi[c_.idx(px, py, pz)];
            v[ok++] = val;
            w_[AX * 2] = 1.f;
        } else if (c_.fm[c_.idx(mx, my, mz)] == kInited) {
            val = c_.phi[c_.idx(mx, my, mz)];
            v[ok++] = val;
            w_[AX * 2 + 1] = 1.f;
        } else {
            bad++;
        }
        return val;
    }

    float distance(int x, int y, int z) {
        int ok = 0, bad = 0;
        float v[3];
        float a = axisValue<0>(x, y, z, ok, bad, v);
        float b = axisValue<1>(x, y, z, ok, bad, v);
        float cc = 0.f;
        if (c_.is3d) {
            cc = axisValue<2>(x, y, z, ok, bad, v);
        } else {
            bad++;
            w_[4] = w_[5] = 0.f;
        }
        // float32 inner arithmetic with double promotion exactly where the
        // reference's Real/double mixing promotes (calculateDistance,
        // fastmarch.cpp:57-125) — heap order is sensitive to the low bits
        float ret = 0.f;
        if (bad == 0) {
            const float ca = v[0], cb = v[1], cz = v[2];
            const float inner = ca * ca + cb * cb - cb * cz + cz * cz
                                - ca * (cb + cz);
            double s = -2.0 * (double)inner + 3.0;
            if (s < 0.0) s = 0.0;
            const float sum3 = ca + cb + cz;  // float adds, then + double
            ret = (float)(0.333333 * ((double)sum3 + DIR * std::sqrt(s)));
            scaleWeights(ret, a, b, cc);
        } else if (bad == 1) {
            const float dv = v[1] - v[0];
            double s = 2.0 - (double)(dv * dv);
            if (s < 0.0) s = 0.0;
            const float sum2 = v[0] + v[1];
            ret = (float)(0.5 * ((double)sum2 + DIR * std::sqrt(s)));
            scaleWeights(ret, a, b, cc);
        } else if (bad == 2) {
            ret = v[0] + (float)DIR;
        }
        return ret;
    }

    void scaleWeights(float ret, float a, float b, float cc) {
        w_[0] *= std::fabs(ret - a);
        w_[1] *= std::fabs(ret - a);
        w_[2] *= std::fabs(ret - b);
        w_[3] *= std::fabs(ret - b);
        w_[4] *= std::fabs(ret - cc);
        w_[5] *= std::fabs(ret - cc);
        float norm = 0.f;
        for (int i = 0; i < 6; i++) norm += w_[i];
        norm = (float)(1.0 / (double)norm);
        for (int i = 0; i < 6; i++) w_[i] *= norm;
    }

    static bool worse(float x, float y) {
        // COMP::compare: "x is on the wrong side of y"
        return DIR > 0 ? (x > y) : (x < y);
    }

    void touchVel(int x, int y, int z) {
        if (!transport_ || !c_.vel || !c_.isEmpty(x, y, z)) return;
        // weighted average of already-marched neighbors, per component
        float val[3] = {0.f, 0.f, 0.f};
        const int64_t n = c_.n;
        auto acc = [&](float w, int xx, int yy, int zz) {
            if (w <= 0.f) return;
            int64_t i = c_.idx(xx, yy, zz);
            val[0] += c_.vel[i] * w;
            val[1] += c_.vel[n + i] * w;
            val[2] += c_.vel[2 * n + i] * w;
        };
        acc(w_[0], x + 1, y, z);
        acc(w_[1], x - 1, y, z);
        acc(w_[2], x, y + 1, z);
        acc(w_[3], x, y - 1, z);
        if (c_.is3d) {
            acc(w_[4], x, y, z + 1);
            acc(w_[5], x, y, z - 1);
        }
        const int64_t i = c_.idx(x, y, z);
        if (c_.isEmpty(x - 1, y, z)) c_.vel[i] = val[0];
        if (c_.isEmpty(x, y - 1, z)) c_.vel[n + i] = val[1];
        if (c_.is3d && c_.isEmpty(x, y, z - 1)) c_.vel[2 * n + i] = val[2];
    }

    void addToList(int x, int y, int z, int sx_, int sy_, int sz_) {
        if (!c_.inBounds(x, y, z, 1)) return;
        const int64_t i = c_.idx(x, y, z);
        if (c_.fm[i] == kInited) return;
        // source-time gate
        float srct = c_.phi[c_.idx(sx_, sy_, sz_)];
        if (worse(srct, maxTime_)) return;

        float t = distance(x, y, z);

        bool found = false;
        if (c_.fm[i] == kOnHeap) {
            found = true;
            if (worse(t, c_.phi[i])) return;  // old value is better
        }
        c_.fm[i] = kOnHeap;
        c_.phi[i] = t;
        touchVel(x, y, z);
        if (!found) heap_.push(HeapEntry{x, y, z, c_.phi[i]});
    }

    void march() {
        while (!heap_.empty()) {
            HeapEntry e = heap_.top();
            heap_.pop();
            c_.fm[c_.idx(e.x, e.y, e.z)] = kInited;
            addToList(e.x - 1, e.y, e.z, e.x, e.y, e.z);
            addToList(e.x + 1, e.y, e.z, e.x, e.y, e.z);
            addToList(e.x, e.y - 1, e.z, e.x, e.y, e.z);
            addToList(e.x, e.y + 1, e.z, e.x, e.y, e.z);
            if (c_.is3d) {
                addToList(e.x, e.y, e.z - 1, e.x, e.y, e.z);
                addToList(e.x, e.y, e.z + 1, e.x, e.y, e.z);
            }
        }
        setBoundaries();
    }

    void setBoundaries() {
        // delta_phi = 0 on the outermost ring (SetLevelsetBoundaries,
        // fastmarch.cpp:180-194): single serial k,j,i pass, each cell
        // applies all its face rules in x,y,z order against the current
        // (partially updated) field — corner/edge results depend on it
        Ctx& c = c_;
        for (int z = 0; z < c.sz; z++)
            for (int y = 0; y < c.sy; y++)
                for (int x = 0; x < c.sx; x++) {
                    const int64_t i = c.idx(x, y, z);
                    if (x == 0) c.phi[i] = c.phi[c.idx(1, y, z)];
                    if (x == c.sx - 1) c.phi[i] = c.phi[c.idx(x - 1, y, z)];
                    if (y == 0) c.phi[i] = c.phi[c.idx(x, 1, z)];
                    if (y == c.sy - 1) c.phi[i] = c.phi[c.idx(x, y - 1, z)];
                    if (c.is3d) {
                        if (z == 0) c.phi[i] = c.phi[c.idx(x, y, 1)];
                        if (z == c.sz - 1)
                            c.phi[i] = c.phi[c.idx(x, y, z - 1)];
                    }
                }
    }

    Ctx& c_;
    float maxTime_;
    bool transport_;
    float w_[6] = {0, 0, 0, 0, 0, 0};
    std::priority_queue<HeapEntry, std::vector<HeapEntry>, Later<DIR>> heap_;
};

// interface test: any inited neighbor on the other side of the surface
bool atInterface(const Ctx& c, bool inward, int x, int y, int z) {
    const int nmax = c.is3d ? 6 : 4;
    for (int nb = 0; nb < nmax; nb++) {
        int px = x + kNb[nb][0], py = y + kNb[nb][1], pz = z + kNb[nb][2];
        if (!c.inBounds(px, py, pz, 0)) continue;
        if (c.fm[c.idx(px, py, pz)] != kInited) continue;
        float pv = c.phi[c.idx(px, py, pz)];
        if ((inward && pv >= 0.f) || (!inward && pv < 0.f)) return true;
    }
    return false;
}

}  // namespace

extern "C" void mtpu_reinit_march(float* phi, const int32_t* flags,
                                  float* vel, int sx, int sy, int sz,
                                  int is3d, float max_time, int ignore_walls,
                                  int correct_outer_layer,
                                  int obstacle_type) {
    Ctx c;
    c.phi = phi;
    c.flags = flags;
    c.vel = vel;
    c.sx = sx;
    c.sy = sy;
    c.sz = sz;
    c.is3d = is3d != 0;
    c.n = (int64_t)sx * sy * sz;
    c.fm.assign(c.n, 0);
    const int nmax = c.is3d ? 6 : 4;

    // ---- inward march
    Marcher<-1> in(c, max_time, false);
    const int zlo = c.is3d ? 1 : 0, zhi = c.is3d ? sz - 1 : 1;
    // InitFmIn is KERNEL(bnd=1): the outermost ring keeps fm=0 — ring
    // cells never count as interface anchors (a cell next to the ring is
    // re-marched from the inside, probe-verified vs the binary)
    for (int z = zlo; z < zhi; z++)
        for (int y = 1; y < sy - 1; y++)
            for (int x = 1; x < sx - 1; x++) {
                const int64_t i = c.idx(x, y, z);
                bool inited = c.phi[i] >= 0.f;
                if (ignore_walls && (flags[i] & obstacle_type) != 0)
                    inited = false;
                c.fm[i] = inited ? kInited : 0;
            }
    for (int z = zlo; z < zhi; z++)
        for (int y = 1; y < sy - 1; y++)
            for (int x = 1; x < sx - 1; x++) {
                const int64_t i = c.idx(x, y, z);
                if (c.fm[i] == kInited) continue;
                if (ignore_walls && (flags[i] & obstacle_type) != 0)
                    continue;
                if (!atInterface(c, true, x, y, z)) continue;
                c.fm[i] = kInited;
                for (int nb = 0; nb < nmax; nb++) {
                    int px = x + kNb[nb][0], py = y + kNb[nb][1],
                        pz = z + kNb[nb][2];
                    if (ignore_walls
                        && (flags[c.idx(px, py, pz)] & obstacle_type) != 0)
                        continue;
                    if (c.phi[c.idx(px, py, pz)] < 0.f
                        && !atInterface(c, true, px, py, pz))
                        in.addToList(px, py, pz, x, y, z);
                }
            }
    in.march();

    // un-reached inside region (SetUninitialized is KERNEL(bnd=1): the
    // outermost ring keeps the values SetLevelsetBoundaries copied there)
    auto set_uninit = [&](float val) {
        for (int z = zlo; z < zhi; z++)
            for (int y = 1; y < sy - 1; y++)
                for (int x = 1; x < sx - 1; x++) {
                    const int64_t i = c.idx(x, y, z);
                    if (c.fm[i] == kInited) continue;
                    if (ignore_walls && (flags[i] & obstacle_type) != 0)
                        continue;
                    c.phi[i] = val;
                }
    };
    set_uninit(-max_time - 1.f);

    // ---- outward march (with velocity transport); InitFmOut also bnd=1
    for (int z = zlo; z < zhi; z++)
        for (int y = 1; y < sy - 1; y++)
            for (int x = 1; x < sx - 1; x++) {
                const int64_t i = c.idx(x, y, z);
                c.fm[i] = (c.phi[i] < 0.f) ? kInited : 0;
                if (ignore_walls && (flags[i] & obstacle_type) != 0) {
                    c.fm[i] = 0;
                    c.phi[i] = 0.f;
                }
            }
    Marcher<+1> out(c, max_time, vel != nullptr);
    if (correct_outer_layer) {
        // seed every cell next to a shallow inside value (moves the
        // interface slightly but keeps a clean SDF)
        for (int z = zlo; z < zhi; z++)
            for (int y = 1; y < sy - 1; y++)
                for (int x = 1; x < sx - 1; x++) {
                    if (ignore_walls
                        && (flags[c.idx(x, y, z)] & obstacle_type) != 0)
                        continue;
                    for (int nb = 0; nb < nmax; nb++) {
                        int px = x + kNb[nb][0], py = y + kNb[nb][1],
                            pz = z + kNb[nb][2];
                        if (c.fm[c.idx(px, py, pz)] != kInited) continue;
                        if (ignore_walls
                            && (flags[c.idx(px, py, pz)] & obstacle_type)
                                   != 0)
                            continue;
                        float nbPhi = c.phi[c.idx(px, py, pz)];
                        if (nbPhi < 0.f && nbPhi >= -2.f)
                            out.addToList(x, y, z, px, py, pz);
                    }
                }
    } else {
        for (int z = zlo; z < zhi; z++)
            for (int y = 1; y < sy - 1; y++)
                for (int x = 1; x < sx - 1; x++) {
                    const int64_t i = c.idx(x, y, z);
                    if (ignore_walls && (flags[i] & obstacle_type) != 0)
                        continue;
                    if (c.phi[i] < 0.f) continue;
                    if (!atInterface(c, false, x, y, z)) continue;
                    c.fm[i] = kInited;
                    for (int nb = 0; nb < nmax; nb++) {
                        int px = x + kNb[nb][0], py = y + kNb[nb][1],
                            pz = z + kNb[nb][2];
                        if (ignore_walls
                            && (flags[c.idx(px, py, pz)] & obstacle_type)
                                   != 0)
                            continue;
                        if (c.phi[c.idx(px, py, pz)] > 0.f
                            && !atInterface(c, false, px, py, pz))
                            out.addToList(px, py, pz, x, y, z);
                    }
                }
    }
    out.march();
    set_uninit(max_time + 1.f);
}

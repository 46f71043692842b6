// Native read intake of dindel_tpu_torch's get_reads: for a window, per
// BAM, decode a region (the same records, in the same order, as
// bamio.cpp's dbam_fetch) and do the per-record work of the arena read
// buffer: the flag prefilter, the count of flag-kept records that the
// "Too many reads in region" cap compares, the pos >= left_fetch filter,
// the buffer's columns and a qname key per kept record.  A window's
// intakes run as one job on a thread of their own, which never touches
// Python: the port starts the next window's job while its main thread
// stages this one.  Each BAM's result is packed into one malloc'ed
// buffer that the caller takes over (dri_block) and frees (dri_free) when
// nothing reads it any more (dindel_tpu_torch/io/reads_intake.py, through
// ctypes).
//
// Qname keys come from a name table that the caller owns and passes in:
// two records get the same key if and only if their names are byte-equal,
// among the records of pos >= the job's prune_below and the records the
// job keeps, for as long as the table is not cleared.  A job first drops
// the names whose last record lies left of prune_below (the read buffer
// slides to it, so no row that holds their key is left), which bounds the
// table by the buffer.  A table and an intake handle are used by one job
// (or the caller) at a time.
//
// Built with -fvisibility=hidden: only the dri_* entry points are
// exported, so the included decoder's symbols never bind to another
// library's copy of them.

#include "bamio.cpp"

#include <atomic>
#include <chrono>
#include <string>
#include <thread>
#include <unordered_map>

#define DRI_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

// SAM flag bits (SAM spec section 1.4)
const int32_t FUNMAP = 0x4, FMUNMAP = 0x8, FREVERSE = 0x10;

struct NameTable {
    struct Entry { int64_t key; int64_t last_pos; };
    std::unordered_map<std::string, Entry> ids;
    int64_t next_key = 0;

    void prune(int64_t below) {
        for (auto it = ids.begin(); it != ids.end();) {
            if (it->second.last_pos < below) it = ids.erase(it);
            else ++it;
        }
    }
};

// Layout of a packed block, every section 8-byte aligned: the kept rows'
// int64 columns (row, pos, size, end, mate_pos0, qid), their uint8
// columns (unmapped, mate_unm, same_tid, reverse, mapq), then the
// decoded arena: fixed int32 n x 8, the qname/cigar/seq/aux offsets
// (int64, n + 1 each), cigar uint32, qname, seq, qual, aux bytes;
// M_TOTAL is the buffer's allocated size.
enum { M_FLAG_KEPT, M_ROWS, M_RECORDS, M_INT_COLS, M_U8_COLS, M_FIXED,
       M_OFFS, M_CIGAR, M_QNAME, M_SEQ, M_QUAL, M_AUX, M_QNAME_LEN,
       M_CIGAR_LEN, M_SEQ_LEN, M_AUX_LEN, M_TOTAL, M_N };

size_t pad8(size_t n) { return (n + 7) & ~(size_t)7; }

struct Intake {
    Handle* h = nullptr;
    int64_t n_flag_kept = 0;
    // one entry per kept record, in decode order
    std::vector<int64_t> icol[6];   // row, pos, size, end, mate_pos0, qid
    std::vector<uint8_t> ucol[5];   // unmapped, mate_unm, same_tid,
                                    // reverse, mapq
    char* packed = nullptr;         // the last intake's, until taken
    int64_t meta[M_N] = {0};

    ~Intake() { free(packed); }

    void clear() {
        free(packed);
        packed = nullptr;
        n_flag_kept = 0;
        for (auto& v : icol) v.clear();
        for (auto& v : ucol) v.clear();
    }

    template <class T>
    size_t put(size_t at, const T* src, size_t n) {
        if (n) memcpy(packed + at, src, n * sizeof(T));
        return pad8(at + n * sizeof(T));
    }

    void pack() {
        const Handle* b = h;
        size_t nr = icol[0].size(), n = b->fixed.size() / 8;
        meta[M_FLAG_KEPT] = n_flag_kept;
        meta[M_ROWS] = (int64_t)nr;
        meta[M_RECORDS] = (int64_t)n;
        meta[M_QNAME_LEN] = (int64_t)b->qname_arena.size();
        meta[M_CIGAR_LEN] = (int64_t)b->cigar_arena.size();
        meta[M_SEQ_LEN] = (int64_t)b->seq_arena.size();
        meta[M_AUX_LEN] = (int64_t)b->aux_arena.size();
        size_t at = 0;
        meta[M_INT_COLS] = at; at += 6 * nr * 8;
        meta[M_U8_COLS] = at; at = pad8(at + 5 * nr);
        meta[M_FIXED] = at; at += n * 8 * 4;
        meta[M_OFFS] = at; at += 4 * (n + 1) * 8;
        meta[M_CIGAR] = at; at = pad8(at + b->cigar_arena.size() * 4);
        meta[M_QNAME] = at; at = pad8(at + b->qname_arena.size());
        meta[M_SEQ] = at; at = pad8(at + b->seq_arena.size());
        meta[M_QUAL] = at; at = pad8(at + b->qual_arena.size());
        meta[M_AUX] = at; at = pad8(at + b->aux_arena.size());
        // allocated in powers of two, so that the caller's views of it
        // come in few sizes
        size_t cap = 8;
        while (cap < at) cap <<= 1;
        meta[M_TOTAL] = (int64_t)cap;
        packed = (char*)malloc(cap);
        if (!packed) throw std::bad_alloc();
        at = 0;
        for (auto& v : icol) at = put(at, v.data(), nr);
        for (auto& v : ucol) {
            if (nr) memcpy(packed + at, v.data(), nr);
            at += nr;
        }
        at = put(pad8(at), b->fixed.data(), n * 8);
        at = put(at, b->qname_off.data(), n + 1);
        at = put(at, b->cigar_off.data(), n + 1);
        at = put(at, b->seq_off.data(), n + 1);
        at = put(at, b->aux_off.data(), n + 1);
        at = put(at, b->cigar_arena.data(), b->cigar_arena.size());
        at = put(at, b->qname_arena.data(), b->qname_arena.size());
        at = put(at, b->seq_arena.data(), b->seq_arena.size());
        at = put(at, b->qual_arena.data(), b->qual_arena.size());
        put(at, b->aux_arena.data(), b->aux_arena.size());
    }
};

// Decode the records of [beg, end) on tid (dbam_fetch) and keep those
// with no bit of drop_flags set (counted in n_flag_kept) and
// pos >= left_fetch, then pack the result.  Returns the number of
// records decoded, or -1 when the BAM has no usable .bai.
int64_t intake(Intake* in, NameTable* nt, int32_t tid, int64_t beg,
               int64_t end, int64_t left_fetch, int32_t drop_flags) {
    in->clear();
    int64_t n = dbam_fetch(in->h, tid, beg, end);
    if (n < 0) return -1;
    const Handle* h = in->h;
    std::string name;
    for (int64_t i = 0; i < n; i++) {
        const int32_t* fx = &h->fixed[8 * i];
        int32_t flag = fx[3];
        if (flag & drop_flags) continue;
        in->n_flag_kept++;
        int64_t p0 = fx[1];
        if (p0 < left_fetch) continue;
        // end position as bam_calend: pos + ref-consuming ops (M D N = X),
        // pos + 1 for an empty CIGAR
        int64_t c0 = h->cigar_off[i], c1 = h->cigar_off[i + 1];
        int64_t ep = p0;
        for (int64_t c = c0; c < c1; c++) {
            uint32_t v = h->cigar_arena[c], op = v & 0xF;
            if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
                ep += (int64_t)(v >> 4);
        }
        if (c1 == c0) ep = p0 + 1;
        name.assign(h->qname_arena.data() + h->qname_off[i],
                    (size_t)(h->qname_off[i + 1] - h->qname_off[i]));
        auto ins = nt->ids.try_emplace(name, NameTable::Entry{nt->next_key,
                                                              p0});
        if (ins.second) nt->next_key++;
        auto& e = ins.first->second;
        if (p0 > e.last_pos) e.last_pos = p0;
        const int64_t iv[6] = {i, p0, h->seq_off[i + 1] - h->seq_off[i], ep,
                               fx[5], e.key};
        for (int k = 0; k < 6; k++) in->icol[k].push_back(iv[k]);
        const uint8_t uv[5] = {(flag & FUNMAP) != 0, (flag & FMUNMAP) != 0,
                               fx[4] == fx[0], (flag & FREVERSE) != 0,
                               (uint8_t)fx[2]};
        for (int k = 0; k < 5; k++) in->ucol[k].push_back(uv[k]);
    }
    in->pack();
    return n;
}

// One window's intakes, BAM by BAM, on a thread of their own.
struct Job {
    std::thread th;
    std::vector<Intake*> intakes;
    std::vector<int32_t> tids;
    NameTable* names;
    int64_t beg, end, left_fetch, prune_below;
    int32_t drop_flags;
    int64_t* out_n;
    double seconds = 0;
    std::atomic<bool> done{false};

    void run() {
        auto t0 = std::chrono::steady_clock::now();
        names->prune(prune_below);
        for (size_t i = 0; i < intakes.size(); i++) {
            try {
                out_n[i] = intake(intakes[i], names, tids[i], beg, end,
                                  left_fetch, drop_flags);
            } catch (...) {  // std::bad_alloc
                out_n[i] = -2;
            }
            if (out_n[i] < 0) break;
        }
        seconds = std::chrono::duration<double>(
            std::chrono::steady_clock::now() - t0).count();
        done.store(true, std::memory_order_release);
    }
};

}  // namespace

DRI_EXPORT void* dri_open(const char* path) {
    void* h = dbam_open(path);
    if (!h) return nullptr;
    Intake* in = new Intake();
    in->h = (Handle*)h;
    return in;
}

DRI_EXPORT void dri_close(void* p) {
    Intake* in = (Intake*)p;
    dbam_close(in->h);
    delete in;
}

DRI_EXPORT void* dri_names_new() { return new NameTable(); }
DRI_EXPORT void dri_names_clear(void* t) { ((NameTable*)t)->ids.clear(); }
DRI_EXPORT void dri_names_free(void* t) { delete (NameTable*)t; }
DRI_EXPORT int64_t dri_names_size(void* t) {
    return (int64_t)((NameTable*)t)->ids.size();
}

// Start the intakes of [beg, end) on tids[i] of intakes[i], i < n, in
// order on a new thread, after pruning the name table below
// prune_below; out_n[i] gets the records decoded, -1 when the BAM has
// no usable .bai, -2 when memory ran out (both end the job).  out_n and
// the handles must outlive the job.  nullptr if no thread could be
// started.
DRI_EXPORT void* dri_job_start(void** intakes, int32_t n, void* names,
                               const int32_t* tids, int64_t beg,
                               int64_t end, int64_t left_fetch,
                               int64_t prune_below, int32_t drop_flags,
                               int64_t* out_n) {
    Job* j = nullptr;
    try {
        j = new Job();
        j->intakes.assign((Intake**)intakes, (Intake**)intakes + n);
        j->tids.assign(tids, tids + n);
        j->names = (NameTable*)names;
        j->beg = beg;
        j->end = end;
        j->left_fetch = left_fetch;
        j->prune_below = prune_below;
        j->drop_flags = drop_flags;
        j->out_n = out_n;
        j->th = std::thread(&Job::run, j);
    } catch (...) {
        delete j;
        return nullptr;
    }
    return j;
}

// Whether a job has finished (so that dri_job_wait returns at once).
DRI_EXPORT int32_t dri_job_done(void* jp) {
    return ((Job*)jp)->done.load(std::memory_order_acquire) ? 1 : 0;
}

// Wait for a job and free it; the seconds it ran.
DRI_EXPORT double dri_job_wait(void* jp) {
    Job* j = (Job*)jp;
    j->th.join();
    double s = j->seconds;
    delete j;
    return s;
}

// The packed block of the handle's last intake: its meta (M_N int64s,
// the layout above) into meta, the buffer as the return value; the
// caller owns it from here on and frees it with dri_free.
DRI_EXPORT char* dri_block(void* p, int64_t* meta) {
    Intake* in = (Intake*)p;
    memcpy(meta, in->meta, sizeof(in->meta));
    char* out = in->packed;
    in->packed = nullptr;
    return out;
}

DRI_EXPORT void dri_free(void* buf) { free(buf); }
